"""Readings of a cell's checks over many seeds in one process: the
program's, the control's, or a planted fault's.  The limits of the check
are set from these (the benchmark's own runs never run the control).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3
        [--seconds 2] [--control | --fault <name>] [--out <file.jsonl>]

Each seed sets the cell up afresh, runs a short window at the cell's own
sizes and load, and checks what it produced, as a run does; one JSON line
a seed is printed (and appended to ``--out``): the seed, ``correct``, each
check's value and limit, and what the window measured.  ``--control``
puts the entry's control in the program's place: the plain reference in
the precision below the configuration's.  ``--fault`` plants one of the
entry's faults in the program.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness

    harness.cache_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    w, cfg = harness.cell_spec(bench, args.workload)
    config = harness.load_json(cfg["file"])
    mod = harness.entry_module(harness.load_json(harness.mix_file(w))["entry"])
    program = None
    if args.control:
        program = mod.control(config)
    elif args.fault:
        program = mod.FAULTS[args.fault]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        line = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                                bench=bench, program=program)
        out = {"workload": args.workload, "seed": seed,
               "side": "control" if args.control else args.fault or "program",
               "correct": line["correct"], "failed": line["failed"],
               "attempted": line["attempted"], "checks": line["checks"],
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "run_s": time.time() - t0}
        text = json.dumps(out)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
