"""Online (streaming) transcription demo (counterpart of
`examples/streaming_demo.py`): features arrive in chunks, the session
decodes incrementally, and the final transcript is checked to be identical
to the one-shot batch decode, the `models/streaming.py` exactness contract.

    python -m warp_rnnt_tpu_torch.examples.streaming_demo [--chunk 16]
                                                          [--beam 0]
                                                          [--device cpu]

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from warp_rnnt_tpu_torch.models import (
    beam_decode,
    greedy_decode,
    init_model,
    stream_finish,
    stream_init,
    stream_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=16, help="frames per chunk")
    ap.add_argument("--beam", type=int, default=0,
                    help="beam width (0 = greedy)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    N, T, F, V, ML = 4, 96, 20, 64, 32
    model, _, batch = init_model(0, vocab_size=V, feat_dim=F, N=N, T=T, U=8,
                                 device=args.device, encoder_hidden=64,
                                 predictor_hidden=64, joint_hidden=64)
    feats = batch[0]
    xn = torch.full((N,), T, dtype=torch.int32, device=args.device)

    # one-shot reference
    if args.beam:
        ref = beam_decode(model, feats, xn, max_length=ML,
                          beam_size=args.beam)
    else:
        ref = greedy_decode(model, feats, xn, max_length=ML)

    # streaming session
    state = stream_init(model, N, max_length=ML, beam_size=args.beam)
    C = args.chunk
    for i in range(0, T, C):
        state = stream_step(model, state, feats[:, i:i + C])
        if args.beam:
            u = state["dec_beam"][3].max(-1).values  # best case an utterance
        else:
            u = state["dec"][1]
        print(f"after frame {min(i + C, T):3d}: emitted so far = {u.tolist()}")
    out = stream_finish(model, state)
    tok, ln = out[0], out[1]

    if not (torch.equal(tok, ref[0]) and torch.equal(ln, ref[1])):
        raise SystemExit("streaming decode differs from the one-shot decode")
    mode = f"beam-{args.beam}" if args.beam else "greedy"
    print(f"\nstreaming ({mode}, C={C}) == one-shot decode: EXACT")
    for i in range(N):
        print(f"  utt {i}: {tok[i, : int(ln[i])].tolist()}")


if __name__ == "__main__":
    main()
