#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`warp_rnnt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card and build: the card's name and power limit, then nvcc builds the
     kernels in `warp_rnnt_tpu_torch/csrc/` (one nvcc per source, together).
  2. the lattice kernel (fused alpha+beta, beta only) against its plain
     torch twin on the card, two calls bit-equal at every case: small ragged
     shapes, T=600, U=1 (xn=1 in one sample) and the main path's full-width
     lattice against the float32 twin; T=1100 and compact case B's lattice
     (N=16, T=1473, U=299, seeded lengths) against the float64 twin.  Then
     the ns of one dependent logaddexp (`cuda_impl.lae_ns`), which sets
     each lattice's chain floor, (T + U - 1) of them.
  3. the gradient-write kernel against its twin: full width, then the cases
     of `benchmarks/flat_write_cases.py` (every output dtype at V = 1, 2,
     28, 50, 127, 128, 131 and 5000, non-finite cotangents, partial last
     blocks, a column offset).  The match must be bit for bit.
  4. the main path at full width (N=32, T=150, U=21, V=5000, fp32):
     `rnnt_loss(..., reduction="mean", gather=True)` + backward on the 4-D and
     the flat 3-D input, and the no-grad costs.  Launch counts are set to 0
     just before and read just after; every kernel must have run.  Costs and
     the 2 GB gradient are held against `impl="scan"` on the card, and the
     golden vectors of `tests/golden.py` run through the port on the card.
  5. times (CUDA events, dependency-forced chains) of each kernel, its twin,
     and loss+grad end to end, each beside its bound (the lattice's also
     beside its chain floor).
  6. the fused joint kernels (forward; backward d_a/d_c and d_W/d_b) against
     their plain torch versions on the card (the cases and tolerances of
     `benchmarks/fused_joint_cases.py`; d_W and d_b held per column group:
     blank, label, other): ragged lengths with xn shorter than one row
     tile, U > 32 with blank=3, U > 64, H=512, V not a multiple of the
     64-column chunk, and the slice's full width.
  7. the fused slice at full width (N=16, T=150, U=21, V=5000, H=F=256,
     bf16 joint, weights carried from a seeded Flax-layout tree):
     `rnnt_loss_fused_joint(..., reduction="mean")` + backward into f, g and
     the four joint parameters, and the no-grad costs.  Launch counts are
     set to 0 just before and read just after; the three fused-joint kernels
     and both lattice kernels must have run.  Held against the port's
     unfused `Joint(normalize=True)` -> `rnnt_loss(gather=True)` on the card
     (w_out and b_out per column group).
  8. times of each fused kernel, its plain version and its bound (bf16
     tensor-core operations), and fused against unfused loss+grad, each
     with its peak device memory.
  9. the packed gather/scatter kernels against their plain versions, exact
     (`benchmarks/packed_cases.py`): the JAX package's edge cases, then
     cases A (N=32, T=150, 20 labels, V=5000) and B (N=16, T=1500, 300
     labels, V=50), random lengths, 13 pad rows.
 10. the compact path at A and B: `rnnt_loss(..., compact=True,
     reduction="mean")` + backward, grad-mode and no-grad costs, counts set
     to 0 just before; the packed kernels and both lattice kernels must
     have run.  Held against the padded port on the same values scattered
     into (N, T, U, V): costs rtol 1e-6, gradient equal at valid cells, pad
     rows 0.  Then the kernels' and the two layouts' times and peak memory,
     and the lattice kernels' times at each case's lattice.
 11. `rnnt_loss_joint` at N=16, T=150, 20 labels, V=5000, H=F=256 in every
     layout (padded, compact, fused, auto), each run with its counts set to
     0 and holding exactly its layout's kernels; compact and fused against
     padded (loss rtol 2e-3, gradients 2e-2, w_out/b_out per column group);
     auto equals the route it names.  Then each layout's loss+grad time and
     peak memory there, at V=28 (40 labels), V=256 and V=1000.
 12. the fused joint at V=64000 (N=2) and V=50257 (N=1): kernels against
     their plain versions (1e-3 per column group), then
     `rnnt_loss_fused_joint` at V=64000 once with its counts set to 0,
     against the padded layout; the kernels' times, and fused and padded
     loss+grad.
 13. the gather experiments' kernels (`csrc/gather.cu`: column gather,
     blank/label gather in (N, T, U) and (N, U, T); `scatter_bwd` runs
     `flat_write`): (a) each against its plain version, exact, on the cases
     of `benchmarks/gather_cases.py` (T=13, C < 128 with a column in the
     last partial 128-lane window, K=80, N=1, blank=3, lab == blank, labels
     and columns out of range, bf16/fp16/fp64); then the slice's path once,
     `benchmarks/exp_gather.py`'s kernel, stream, sparse and scatter
     variants at N=32, counts set to 0 just before.  (b) At N=32 (2.02 GB),
     128 (7.5 GiB, the JAX experiments' shape) and 144 (9.07 GB, past 2^31
     elements): each gather against its plain version and the one
     `torch.gather` call that gives the same values (the library
     yardstick), exact, with kernel, device, plain, library and bound ms.
     (c) `scatter_bwd` against its plain version, whole at N=32, per sample
     at 128 and 144, with its times.  (d) The main path at N=128 and 144:
     loss+grad on the 4-D input and the no-grad costs, counts set to 0
     just before; costs against `impl="scan"` on the card, the gradient of
     three whole samples against one-sample calls (offsets below 2^31) and
     of the last against the plain CPU path; loss+grad ms and peak memory.
Slice 6 (the fused backward kernels on wgmma) adds, inside phases 6-8 and
12: two backward calls bit-equal (full width, H=512); each backward
kernel's registers, spills and shared memory; one bf16 torch.matmul at the
slice's shape as a yardstick; the kernels against their plain versions and
their times at H=512 and V=50257; and `rnnt_loss_joint` padded and fused
in turns at V=28, 256 and 1000, and at V=5000 and 64000 for H=256, 512,
640 and 1024, chained and under the profiler (device busy ms, idle share),
the readings CUDA "auto" rests on.
Slice 7 (the fused forward on wgmma, on the backward's W and h images)
adds: two forward calls bit-equal (full width, H=512, V=64000); the
forward's registers, spills and shared memory beside the backward's (also
in the kernels line); the forward's time at every timed shape (H=256,
512, 640, 1024, V=64000, V=50257) beside one bf16 torch.matmul of the
same (R, H) x (H, V); and the fused slice's step under the profiler
(kernels a call, idle share, device time by kernel).  One h kernel is
left, the h image kernel, counted `fused_joint_hidden` (once before the
forward, once before the backward past one 256-column slice).

Slice 8 (the lattice sweep as a warp pipeline over (T, U)) adds, inside
phases 2, 5 and 10: the new lattice cases and bit-equality above; the
lattice kernel's plan, registers, spills and shared memory at the main
path's lattice and at B's (also in the kernels line, `attrs`); the lattice
times' bound counted from what the recurrence needs (8 operations a cell and
direction) with the chain floor beside it, at the main path and at compact
A and B (the kernels line's `case_A` and `case_B`).
Slice 9 (the packed gather as one host call to the (N, T, U, 2) lattice;
the h image kernel from shared memory) adds: in phase 9 the gather entry's
lattice, row labels and prefix sums and the scatter from them bit for bit
against their plain versions, also under the NaN rule; in phase 10 each
packed kernel's chained, device (CUDA graph) and host-us times at A and B
beside its byte bound (`benchmarks/packed_step.py`; the gather's 32- and
64-byte sector floors printed beside), and the compact step at A and B
under the profiler (kernels a call, device busy ms, idle share); with the
fused kernels' times at H=512, 640 and 1024 the h image kernel's device ms
and host us (`benchmarks/h_image.py`; its tanhf count printed beside).
The kernels line holds, besides `bound_ms` and the compiler's `attrs`,
only numbers this run measured: the chain floors, sector floors, tanhf
counts and bound shares stand on the `time` lines.  `packed_gather`'s
launches count both kernels of its entry, the prefix scan and the gather.
Slice 10 (the transducer model and its train step) adds phase 14, after
the gathers: the model at bench_train.py's width (`train_cases.FULL`:
N=32, T=400, U=40, V=1024, 80 features, hidden 512, two conv blocks,
"add" joint), carried from a seeded Flax-layout tree, in each loss mode
("from_logits", "gather", "fused"): the step-0 loss and gradients with the
launch counts set to 0 just before and read just after (exactly the mode's
kernels: the lattice; the gather, lattice and write; the lattice, the h
image, the fused forward and both backward kernels), all finite, "gather"
and "fused" against "from_logits" (loss rtol 2e-3, each gradient rtol 0.1
and atol 3e-2 of its largest); the lattice sweep of each mode's step 0,
on the inputs it was given there, against the plain version in float64
(alphas and betas on valid cells 1e-5 |p| + 1e-5, costs rtol 1e-5,
gradients 5e-3 of the largest); five AdamW steps with the loss falling;
one small step on the card against the same step on the CPU (gradients
as above; after one AdamW step the parameters within 1e-2 lr wherever
the two gradients share a sign above 1e-5); then
`benchmarks/bench_train.py` (chained step ms, kernels a step, device busy
ms, idle share, peak MB, bound ms, the top kernels by device ms).  Each
kernel the step launches gains a `train` entry in the kernels line: its
launches a step and its device ms a step, by mode, and its bound a step;
the lattice's also its largest error on valid cells by mode.
Slice 11 (the serving path) adds phase 15, after the train step
(`benchmarks/serving_cases.py`): `rnnt_loss_restricted` at the main
path's shape (N=32, T=150, U=21, V=5000, fp32, label frames from
`rnnt_alignment` on the same log-probs, bands 15 left and 5 right) with
the counts set to 0 just before and read just after each call (loss+grad:
the gather, the lattice and the write; no-grad: the gather and the
beta-only sweep), against `impl="scan"` on the card (costs rtol 1e-5,
gradients 5e-3 of the largest), a huge band equal to `rnnt_loss` bit for
bit, two infeasible samples (bands out of order) +inf under 'none' with
exactly zero and finite gradients and left out of 'sum' and 'mean', an
all-infeasible batch 0; its loss+grad and no-grad ms chained beside
`rnnt_loss`'s, with the kernels a call under the profiler; the alignment
on the card against the CPU (frames equal, scores rtol 1e-5), its Viterbi
scores at most minus the kernel path's costs, and its ms.  The decoders
at bench_decode.py's width (N=32, T=400, 80 features, hidden 512,
V=1024, beam 4, max_length 100; weights from `train_cases.flax_tree`):
beam 1 equals greedy, beam tokens in [1, V), each beam score at most its
tokens' Viterbi score on the model's full lattice + 1e-3; a small fp32
model decodes to the CPU's tokens on the card; then `bench_decode`
(greedy and beam ms, utts/s, loop iterations, kernels, busy, idle, peak).
Streaming at bench_streaming.py's width (N=8, C=16, V=1024, hidden 512,
160 frames, ragged lengths): chunked equals one-shot exactly (tokens,
lengths, beam-4 scores) at C=16, C=7 (a ragged tail) and C=1 on the
first 64 frames; then `bench_streaming` greedy and beam 4 (chunk ms,
frames/s, ms a frame a stream, iterations, busy, idle).  The gather, the
lattice kernels and the write gain a `serving` entry in the kernels line:
their launches in each serving call and the restricted loss's errors
against the scan.
Slice 12 (the parallel tier) adds phase 16, after the serving path
(`benchmarks/parallel_cases.py`): the vocabulary-shard kernels (the
gather and the write with a column offset) against their plain twins,
exactly, on each half of a split vocabulary (V=5000 with the blank in
either block and on the second block's first column, labels on both sides
of the boundary; bf16; a rank's shape in the 2x2 world's main path, 16
samples and 2500 columns), the halves summing to the whole; their largest
measured difference goes into the kernels line.  Then a 1-rank
NCCL world on cuda:0: the main path at full width through
`rnnt_loss_sharded` and `rnnt_loss_shard_map` ("mean", backward; "none")
bit-equal to `rnnt_loss(gather=True)` in costs and gradient, with the
counts set to 0 just before and read just after (the gather, the lattice
and the write); the sharded and the plain loss+grad chained in turns and
under the profiler (kernels a call, busy, idle, the NCCL kernels' device
ms); `bench_scaling` at 1 rank (lattices/s); `make_sharded_train_step` on
a 1x1 ('data', 'model') mesh at bench_train.py's width in each loss mode
against the single-process step (`train_cases.compare_grads`,
`compare_steps`), its chained step ms beside phase 14's.  A model axis of
one rank splits nothing, so the step takes the single-process loss; the
vocabulary-parallel route is called on its own there, over NCCL, and its
gradients held against the same step's.  Then a 2x2 gloo world of 4 processes on cuda:0 (the kernels
on the card, the collectives through the host, whose time is not
measured): the main path split over 'data' (16 samples) and 'model' (2500
columns) against the single-process call (costs and mean rtol 1e-6, each
rank's gradient block exactly), compact case A and the restricted loss
(bands 15/5, two infeasible samples) over 'data' (mean rtol 1e-6,
gradients 1e-6 of the largest), `dryrun_multichip(4)` (the same losses on
every rank) and one "from_logits" train step at bench_train.py's width
against the single-process step.  The kernels of the path gain a
`parallel` entry: their launches in each of those calls (rank 0's in the
2x2 world).  NCCL across several cards is not exercised: the machine has
one.
Slice 13 (the benchmark tier) adds phase 17, after the parallel tier
(`benchmarks/bench_cases.py`): `bench_loss.headline()` (bench.py's
measurement on the port, N=32, T=150, 20 labels, V=5000); `run_table.main`
into a temporary file, warp-rnnt's README table (T=150, 40 labels, V=28;
T=150, 20 labels, V=5000; T=1500, 300 labels, V=50; N = 1, 16, 32, 64,
128), one child process a row, every row's loss+grad and no-grad ms with
its bound and peak, and no row may hold an error; the N=1 row of each
config against `impl="scan"` on the same inputs (costs rtol 1e-5,
gradient 5e-3 of the largest), with its gather and its write on the
row's own log-probs and cotangents against their plain versions, bit for
bit, and the padded T=1500, 301-row lattice at
N=128 against the float64 twin on samples 0, 1, 64 and 127; `bench_joint`
at its full width (N=16, T=150, 20 labels, V=5000, H=256) in its five
modes, full and random lengths: each mode against "log_softmax+gather"
(loss rtol 2e-3, gradients 2e-2 of the largest), launching exactly its
route's kernels, then its step ms, peak, kernels a call, busy and idle;
and `utils.profiling.op_breakdown` of a `trace` of three main-path calls,
which must name the gather, lattice and write kernels.  The kernels of
the phase gain a `bench` entry: their launches in each of those calls.
Slice 14 (the gradient write tiled by rows for every V) adds: in phase 3
the write's cases above, each with its tiling (the rows a block read from
the library, `flat_kernels.kernel_block_rows`); in phase 5 the
write's device ms at the main path (CUDA graph) and its sweep over V in
{28, 50, 131, 1024, 5000}, fp32 and bf16, at a 2 GB output
(`benchmarks/write_sweep.py`: chained and device ms beside the byte bound
and one `zero_()` of the same output, the card's reachable store rate);
after phase 13's N=144 main path the write's output past 2^31 elements
(fp32 and bf16) against the plain version 16 samples at a time, bit for
bit; and from phase 17's profiles the write's device ms a loss+grad at
the table's N=128 rows.  All of these go into the `flat_write` entry of
the kernels line (`sweep`, `past_2_31`, `bench.device_ms`).
Slice 15 (the TensorFlow front end) adds phase 18, after the benchmark
tier (`benchmarks/bridge_cases.py`): whether TensorFlow is on the machine
(`importlib.util.find_spec`, then its version and CUDA build from a child
`python -c`); the bridge's torch half (`bindings/_bridge.py`, the body of
`tf_binding.rnnt_loss(graph=False)` without TensorFlow) at the main
path's full width (N=32, T=150, U=21, V=5000, fp32), with blank=0 and on
the pre-gathered lattice (blank=-1), each with the counts set to 0 just
before and read just after (exactly the gather, the lattice and the
write; the lattice), against the plain version on the same inputs (costs
rtol 1e-5, gradient 5e-3 of the largest) and against the direct
`rnnt_loss` loss+grad bit for bit; its ms beside the direct loss+grad's,
and the phase's peak device memory.  Where TensorFlow is present, it
first turns on memory growth for every GPU, then runs
`tf_binding.rnnt_loss(graph=False)` under a GradientTape on TF GPU tensors
at the same shape, and `tf_binding.rnnt_loss_fused_joint` at
bench_joint's shape (N=16, T=150, 20 labels, V=5000, H=256), each against
the direct torch call bit for bit, with the bridge's overhead in ms and
both allocators' peaks.  The gather, the lattice and the write gain a
`tf` entry in the kernels line: their launches in each of those calls and
each call's errors.
Slice 16 (the decode loop on the card) adds, inside phase 15: the
decoders' loops run through `utils/device_loop.py` (JAX's
``lax.while_loop`` as rounds of masked steps, each round one CUDA graph,
one host read of the loop's flag a round).  At bench_decode.py's width,
fp32 and bf16, greedy and beam 4 through the graphs equal the plain loop
(`device_loop._plain`: the same steps run eagerly on the card) bit for
bit in tokens, lengths and scores, with the same trip count and (since
slice 25) one host read a drain; a second decode of one shape
captures no graph, nor does one of another length that pads to the same
width (`decoding.pad_frames`), and one with TF32 flipped captures one.  Chunked
sessions at C=16, 7 and 1 equal the one-shot decode through the graphs and
the plain loop's sessions bit for bit.  `bench_decode` and
`bench_streaming` run plain and graphed, side by side (host reads, the
graph's capture ms, pool MiB, kernels and device us a step).  The graph's
kernels a step are on the `time` lines.
Slice 17 (the decode step's kernels, `csrc/decode_step.cu`) adds, inside
phase 15: at bench_decode.py's width, fp32 and bf16, a plain greedy and a
plain beam decode (the step's plain versions, `decode_step.PLAIN`, the
loop eager) record every 16th call of each step function; each recorded
call goes through `decode_joint` and `decode_gru` and their plain
versions (`benchmarks/decode_step_cases.py`: logp within its stated
tolerance, ids equal where the plain margin exceeds twice it, the GRU's
state within 1e-5, non-emitting rows and greedy's integer fields bit for
bit), and whole decodes on the kernels are compared with the plain
step's tokens (the share equal, reported); then both kernels at odd
widths (H=200, V=29, 5 to 111 rows, add and concat); each kernel's device
ms beside its plain version's and its bound (`bench_decode.kernel_bounds`)
at greedy's and beam's rows; greedy and beam decodes from an empty graph
cache with the counts set to 0 just before and read just after (the
warm-up and capture rounds: a replay launches without Python); and in
the graphed `bench_decode` run, a profile of a replay gates on the step
kernels running, at most 4 launches a step, and no gemm, gru_cell,
softmax or tanh kernel left in the step.  `decode_joint` and
`decode_gru` join the kernels line, with launches a step from that
profile.
Slice 18 (beam's selection as one kernel, `decode_beam_select`, and the
parents' rows read through `decode_gru`'s row map) adds, inside phase
15: in fp32 and bf16 the recorded beam states' selections through the
kernel and its plain version, bit for bit on every output
(`decode_step_cases.check_select_records`), and a beam decode and a
streaming beam session (C=16) on the kernels against the same on the
parent's path (`decode_step_cases.PARENT`: the selection plain, the
joint and the GRU on their kernels), bit for bit in tokens, lengths and
scores; the kernel on hand-built adversarial states at B = 1, 4, 8
(`select_cases`); its device ms beside its plain version's and its
bound at beam's rows; the decoders' main path launching it; and the
replay's profile gating beam on the joint, the selection and the GRU
(the last two once a step), at most 5 step launches (greedy 4), and no
gather, index_select, argmax or cat kernel left in a step.
`decode_beam_select` joins the kernels line.
Slice 19 (the dense and GRU kernels redesigned: K split over a
thread-block cluster, each block's share staged at once, programmatic
dependent launch) adds, inside phase 15: each step kernel timed with L2
warm and flushed, in turns with the first kernels
(`csrc/decode_step_baseline.cu`, `decode_step_cases.BASELINE`), beside a
bf16 `F.linear` a dense layer and a `torch.gru_cell` (yardsticks the
port never calls); the kernels at a wide model's widths (hidden 1024,
V=5000, 16 and 64 rows) and at widths whose K shares take a ring of
stages, against the plain versions under the same tolerances; two calls
of each kernel bit for bit; a captured step's programmatic edges; and
one `time` line a decoder with the graphed step's us on the first
kernels and on these, in turns.  The kernels line gives each step
kernel's clusters and ptxas's registers, shared memory and spills.
Slice 20 (the post-sweep epilogue as one kernel; the lattice and the
dense write reading the interleaved lattice and cotangent) adds, after
phase 3: `epilogue_kernel` against `epilogue_plain` bit for bit
(`benchmarks/epilogue_cases.py`: the main path's lattice, an edge case
with xn = 0, yn >= U, a tripped canary, -inf and NaN log-probs and
FastEmit 0.3, and compact B's lattice; fp32 and bf16 outputs, the edge
case also fp16 and fp64; strides 1 and 2), the lattice at stride 2
against stride 1 and `flat_write` from the interleaved cotangent against
two planes, bit for bit; after phase 4 the public fp32 and bf16 main path
against the same call with the plain epilogue in the kernel's place, bit
for bit; in phase 5 the epilogue's chained, plain and device ms beside its
byte bound at the main path and at T=1500, N=128; in phase 13 the
headline's profile gated on the gather, the lattice, the epilogue and the
write once a call and at most 8 other kernels.  `lattice_epilogue` runs
once a grad call on every loss path (main, fused, compact, joint layouts,
train, serving, parallel, bench, tf) and joins the kernels line with
ptxas's registers and spills.
Slice 21 (the loss+grad compiled once a shape, `utils.compiled_step`:
one CUDA graph, the log-probs donated to the gradient) adds, after phase
5, `phase_compiled_main` (`benchmarks/compiled_cases.py`): at the
headline (N=32, T=150, 20 labels, V=5000) in fp32, bf16 and the flat
layout, each with reduction "none", "sum" and "mean", average_frames and
FastEmit 0.3, and at the README table's six rows (T=150, 40 labels, V=28;
T=150, 20 labels, V=5000; T=1500, 300 labels, V=50; N=1 and 128), the
compiled loss+grad and no-grad costs equal the same function called
eagerly bit for bit, on the capture's log-probs and again after new ones
are copied into the static buffers; the gradient comes back in the
log-probs' buffer; a donated chain of 50 calls copies no argument and
does not grow the allocated memory; a headline replay launches the eager
call's 10 kernels (profiled side by side); with ``WARP_RNNT_DEBUG=1`` a
compiled call whose canary trips warns after each replay.  Each row
prints its chained ms eager and compiled, the capture ms and the graph's
pool MiB.  The compiled timers count launches at capture only, so every
gate on launch counts (here and in phase 17's checks) runs eager calls.
Slice 22 (the streaming chunk's encoder step and `bench_joint`'s step
compiled the same way) adds, after phase 15, `phase_compiled_serving`
(`benchmarks/compiled_serving_cases.py`): at bench_streaming's width (N=8,
C=16, V=1024, hidden 512, T=150: a ragged tail of 6), greedy and beam 4,
with ragged ``xn`` and without, every chunk's whole session state and the
finish equal the same session run eagerly (`compiled_step._plain`) bit for
bit, one encoder replay a chunk; chunked equals one-shot; two interleaved
sessions of one shape each equal their one-shot decode; a steady chunk's
kernels, busy ms and the port's launches (D1-D3) under the profiler, and
the encoder graphs' capture ms and pool MiB.  At bench_joint's shape
(N=16, T=150, U=20, V=5000, H=256), full and random lengths, the compiled
step equals the eager one bit for bit in log_softmax+gather, from_logits,
fused and auto, on the capture's inputs and on new ones, with a replay's
kernels beside an eager call's (the port's launches in the kernels line,
``compiled_joint_step``) and the kernels whose replay is slowest against
eager; the compact mode's capture raises on its host read.
Slice 23 (the train step compiled whole, `models.compiled_train_step`,
and the compact loss compiled with static bounds) adds: in phase 14,
`bench_train` compiled and eager in one call a mode (the compiled
step's replays under the profiler; the eager step's chained ms goes on to
phase 16); after phase 14, `phase_compiled_train`
(`benchmarks/compiled_train_cases.py`): at bench_train's width in each
loss mode, from a fresh model and a fresh capturable AdamW, the first
compiled call equal to one eager step (`compiled_step._plain`) in the
parameters and AdamW's state, 5 calls equal to 5 eager steps (bit for
bit where two eager runs are; else within `train_cases.compare_steps`'
tolerance, the differing tensors named), the loss falling, the step
against the eager non-capturable step within `train_cases.STEP_ATOL`,
capture ms and pool MiB, each mode's graph released before the next;
compact A and B compiled with static bounds against eager bit for bit
(loss, packed gradient, no-grad costs), with each replay's kernels beside
the eager call's.  In phase 15's compiled joint step compact compiles,
and compact without its bounds fails its capture.  The kernels line's
`train` entries gain `launches_a_replay`, and the packed and lattice
kernels a `compiled_compact` entry.
Slice 24 (the device loop's mask and count folded into the step's
kernels: `device_loop.while_loop(folded=True)`, `decode_gru_greedy`
given last_tok and the count, `decode_beam_select` given the count)
adds, inside phase 15: in fp32 and bf16 every recorded greedy GRU and
beam selection call folded, with the loop's cond true and false, against
its folded plain version (`decode_step_cases.check_fold_records`: the
integers, last_tok, the count and the selection bit for bit, the state
within 1e-5 and equal to the unfolded kernel's); the same at odd, wide
and ring widths and on the adversarial selection states
(`select_fold_cases`); the folded greedy, beam 4 and streaming drains
(sessions of C=16) through the graphs against the unfolded drains on the
same kernels (`decode_step_cases.UNFOLDED`: the loop's own mask), eager
and graphed, bit for bit on the whole state with the same trip counts
(`check_fold`); one and two captured folded steps' edges, the GRU to the
next step's hidden layer programmatic (`step_edges`); the graphed step's
us, its kernels a step and a drain's ms unfolded / folded / folded /
unfolded; and the replay's profile gating on no ``where`` kernel and
fewer kernels a round outside the step's than steps.  In
`phase_compiled_serving`, a compiled chunk's ``where`` kernels.
Slice 25 (the device loop whole on the device: each loop one launch of a
CUDA graph conditional while node, `csrc/device_loop.cu`, with one host
read after it) adds, inside phase 15 (`device_loop_checks`,
`benchmarks/device_loop_cases.py`): toy loops at unroll 1, 4 and 16, a
loop whose cond is false at entry and one past its bound against the
eager loop (`device_loop._plain`) bit for bit with one host read;
`loop_continue_kernel` against the eager loop's stop rule on a probe
that counts its steps; greedy, beam 4 and sessions of C=16 at bench width
against the plain loop on the whole state with one host read a drain;
the bodies' node kinds and edges (as built and as captured); the
drains' while launch alone at unroll 1, 4 and 16; the node's us a round
beside the plain loop's.  The graphed-vs-plain checks of slices 16 and 24
now hold one host read a drain.  `loop_continue_kernel` joins the
kernels line (launches: the while launches of the decoders' main path).
`phase_compiled_serving` prints a chunk's host reads (1) beside its idle
share.
Slice 26 (a whole decode and a whole streaming chunk as one CUDA graph a
shape, the drain's while node inside it: `csrc/device_loop.cu`
`device_loop_capture`) adds, after `phase_compiled_serving`,
`phase_compiled_decode` (`benchmarks/compiled_decode_cases.py`): at
bench_decode's width (N=32, T=400, V=1024, hidden 512) the compiled greedy
and beam 4 decodes' first calls (their launches, gated on the step's
kernels and `loop_continue_kernel`) and a call's profile; the compiled
decodes against the eager decode (`compiled_step._plain`) and the plain
loop (`device_loop._plain`) bit for bit on ragged lengths, other
features and every length 0 (cond false at entry), one replay and one
host read a steady call, the runtime calls a call, exactly one
conditional node in the outer graph; a compiled toy loop past its bound
raising the eager loop's error after its replay, the next call right; a
held loop through `device_loop.clear()` and eviction; a compiled decode
after a compiled train step's in-place updates equal to an eager decode;
each call timed by CUDA events in turns with the eager decode, beside
the while launch alone (no reading under it) and the graph's replay
alone; at bench_streaming's width (N=8, C=16, T=150) compiled sessions
against eager and plain bit for bit, interleaved sessions, and a steady
chunk timed in turns with the eager one.  The step's kernels and
`loop_continue_kernel` carry ``compiled_decode`` launches in the kernels
line (a first call's, and a call's from its profile).  Phase 15's
`bench_decode` and `bench_streaming` readings are compiled, the eager
decode beside.
It prints the kernels' JSON line and the card's line, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result.
"""

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N, T, U, V = 32, 150, 21, 5000  # warp-rnnt's headline config, U = 20 labels + 1
SEED = 0

# The fused joint slice: bench_joint.py's configuration, U = 20 labels + 1.
FJ = dict(N=16, T=150, U=21, V=5000, H=256, F=256)

# The card's rates come from `benchmarks.timing.card_rates`: (HBM bytes/s,
# fp32 FLOP/s, dense bf16 tensor-core FLOP/s); BF16 indexes the last.
BF16 = 2


def bound_ms(nbytes, nops, rates, op_rate=1):
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nops / rates[op_rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(torch, n, t, u, v, seed, device="cuda"):
    """Seeded log_softmax log-probs (n, t, u, v), labels (n, u-1) in [1, v),
    full lengths; all int32 where the loss wants int32."""
    g = torch.Generator(device=device).manual_seed(seed)
    log_probs = torch.log_softmax(
        torch.randn(n, t, u, v, generator=g, device=device), dim=-1
    )
    labels = torch.randint(1, v, (n, u - 1), generator=g, device=device,
                           dtype=torch.int32)
    xn = torch.full((n,), t, dtype=torch.int32, device=device)
    yn = torch.full((n,), u - 1, dtype=torch.int32, device=device)
    return log_probs, labels, xn, yn


def random_lattice(torch, n, t, u, seed, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    lp = torch.log_softmax(torch.randn(n, t, u, 3, generator=g, device=device), -1)
    return lp[..., 0].contiguous(), lp[..., 1].contiguous()


def valid_mask(torch, xn, yn, t, u):
    ti = torch.arange(t, device=xn.device)[None, :, None]
    ui = torch.arange(u, device=xn.device)[None, None, :]
    return (ti < xn[:, None, None]) & (ui <= yn[:, None, None])


def seeded_lengths(torch, n, t, u, seed):
    """Lengths in [t/2, t] and [0, u-1] from a seed, the first sample full,
    int32 on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    xn = torch.randint(t // 2, t + 1, (n,), generator=g)
    yn = torch.randint(0, u, (n,), generator=g)
    xn[0], yn[0] = t, u - 1
    return xn.int().cuda(), yn.int().cuda()


# B's lattice: compact case B's (N, T_max, U_max) at CASE_B's seed.
LATTICE_B = (16, 1473, 299)


def phase_lattice(torch, cuda_impl, main_lattice):
    """Kernel vs twin on valid cells: |k - p| <= 1e-5 |p| + 1e-5.  The twin
    runs the kernel's order of combines with the same logaddexp, so on the
    card the two agree to the rounding of the same operations.  The ragged,
    long_T, U=1 and full-width cases are held against the float32 twin, as
    before; the long lattices (T=1100, B's) against the twin in float64,
    which shows what float32 itself costs there.  Two calls must be
    bit-equal at every case."""
    i32 = dict(dtype=torch.int32, device="cuda")
    f32, f64 = torch.float32, torch.float64
    cases = [
        ("ragged", f32, *random_lattice(torch, 6, 37, 9, 1),
         torch.tensor([37, 20, 1, 37, 5, 30], **i32),
         torch.tensor([8, 3, 0, 8, 0, 5], **i32)),
        ("long_T", f32, *random_lattice(torch, 3, 600, 4, 2),
         torch.tensor([600, 333, 257], **i32), torch.tensor([3, 1, 2], **i32)),
        ("U=1", f32, *random_lattice(torch, 3, 40, 1, 4),
         torch.tensor([40, 1, 17], **i32), torch.tensor([0, 0, 0], **i32)),
        ("T=1100", f64, *random_lattice(torch, 4, 1100, 9, 5),
         *seeded_lengths(torch, 4, 1100, 9, 5)),
        ("B", f64, *random_lattice(torch, *LATTICE_B, 6),
         *seeded_lengths(torch, *LATTICE_B, 6)),
        ("full_width", f32, *main_lattice),
    ]
    errs = {}
    for name, ref_dtype, blank, emit, xn, yn in cases:
        mask = valid_mask(torch, xn, yn, blank.shape[1], blank.shape[2])
        for compute_alpha in (True, False):
            ka, kb = cuda_impl.alpha_beta(blank, emit, xn, yn, compute_alpha)
            again = cuda_impl.alpha_beta(blank, emit, xn, yn, compute_alpha)
            pa, pb = cuda_impl.alpha_beta_plain(blank, emit, xn, yn,
                                                compute_alpha, dtype=ref_dtype)
            torch.cuda.synchronize()
            pairs = [(kb, pb)] + ([(ka, pa)] if compute_alpha else [])
            if not all(torch.equal(x, y) for x, y in zip((ka, kb)[not compute_alpha:],
                                                          again[not compute_alpha:])):
                raise AssertionError(f"lattice {name} compute_alpha={compute_alpha}:"
                                     " two calls differ")
            err = 0.0
            for k, p in pairs:
                k, p = k[mask].to(ref_dtype), p[mask]
                if not torch.isfinite(k).all():
                    raise AssertionError(f"lattice {name}: non-finite valid cell")
                diff = (k - p).abs()
                if not (diff <= 1e-5 * p.abs() + 1e-5).all():
                    raise AssertionError(
                        f"lattice {name} compute_alpha={compute_alpha}:"
                        f" max abs err {float(diff.max())}"
                    )
                err = max(err, float(diff.max()))
            kname = "lattice_fused" if compute_alpha else "lattice_beta_only"
            print(f"lattice {kname} {name} {tuple(blank.shape)}: max abs err"
                  f" on valid cells {err} against the {ref_dtype} twin;"
                  " two calls bit-equal")
            if name == "full_width":
                errs[kname] = err
            elif name == "B":
                errs[f"{kname} B"] = err
    return errs


def lattice_attrs(cuda_impl):
    """The lattice kernel's plan, registers, spills and shared memory at the
    main path's lattice and at B's."""
    out = {}
    for label, (t, u) in (("main", (T, U)), ("B", LATTICE_B[1:])):
        out[label] = cuda_impl.kernel_attrs(t, u)
        print(f"lattice kernel attrs {label} T={t} U={u}: {json.dumps(out[label])}")
        if out[label]["spill_bytes"]:
            print(f"WARNING: the lattice kernel spills at T={t}")
    return out


def phase_write(torch, fk, fwc, loc_rows):
    """Kernel vs plain version, bit for bit: the main path's full width
    (rows where loc == blank), then every case of
    `benchmarks/flat_write_cases.py` (V 1, 2, 28, 50, 127, 128, 131 and
    5000 in fp32, fp64, fp16 and bf16; non-finite cotangents; partial last
    blocks; rows that are not whole 16-byte vectors; a scalar tail; a
    column offset)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    ct0 = torch.randn(N, T, U, generator=g, device="cuda")
    ct1 = torch.randn(N, T, U, generator=g, device="cuda")
    k = fk.flat_grad_write(ct0, ct1, loc_rows, 0, V, U * V)
    p = fk.flat_grad_write_plain(ct0, ct1, loc_rows, 0, V, U * V)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError("flat_write full width: kernel != twin")
    print(f"flat_write full width {tuple(k.shape)} float32: exact")
    del k, p
    for name in fwc.CASES:
        r = fwc.compare(fk, name)
        print(f"flat_write {name}: bit for bit (NaN rows alike); {json.dumps(r)}")
    return ct0, ct1


def epilogue_bytes(n, t, u, out_size):
    """The bytes the epilogue must move: alpha, beta, blank and emit read
    once (16 B a cell), two gradients written (2 * out_size a cell), the
    lengths read and the costs and mask written."""
    return n * t * u * (16 + 2 * out_size) + n * (4 + 4 + 4 + 1)


def phase_epilogue(torch, ec, cuda_impl, fk):
    """The epilogue kernel against `epilogue_plain` on the card, bit for
    bit (`benchmarks/epilogue_cases.py`): the main path's lattice, the edge
    case (xn = 0, yn >= U, a tripped canary, -inf and NaN log-probs,
    FastEmit 0.3) and compact B's lattice, each in fp32 and bf16 outputs
    (the edge case also fp16 and fp64) at strides 1 and 2.  Then the
    lattice at stride 2 against stride 1 and `flat_write` from the
    interleaved cotangent against two planes, bit for bit."""
    for name in ec.CASES:
        r = ec.compare(cuda_impl, name)
        print(f"epilogue {name} {ec.CASES[name]}: kernel equals the plain"
              f" version bit for bit; {json.dumps(r)}")
    for name in ("edges", "main"):
        ec.lattice_strides(cuda_impl, name)
        print(f"lattice {name}: the interleaved lattice at stride 2 equals"
              " two planes bit for bit, fused and beta only")
    for name in ("V=50 fp32", "V=5000 bf16", "V=131 fp16", "V=1 fp64"):
        r = ec.write_strides(fk, name)
        print(f"flat_write {name}: the interleaved cotangent at stride 2"
              f" equals two planes bit for bit; {json.dumps(r)}")
    return 0.0


def check_plain_epilogue(torch, wt, cuda_impl, inputs):
    """The public main path's loss and gradient, fp32 and bf16, against the
    same call with `epilogue_plain` in the kernel's place (the torch code
    the parent ran, written to the same outputs), bit for bit."""
    log_probs, labels, xn, yn = inputs
    kernel = cuda_impl.epilogue
    for dtype in (torch.float32, torch.bfloat16):
        x0 = log_probs.to(dtype)
        out = []
        for fn in (kernel, cuda_impl.epilogue_plain):
            cuda_impl.epilogue = fn
            try:
                x = x0.detach().requires_grad_()
                loss = wt.rnnt_loss(x, labels, xn, yn, reduction="mean",
                                    gather=True)
                loss.backward()
            finally:
                cuda_impl.epilogue = kernel
            out.append((loss.detach(), x.grad))
        (lk, gk), (lp, gp) = out
        if not (torch.equal(lk, lp) and torch.equal(gk, gp)):
            raise AssertionError(f"main path {dtype}: the epilogue kernel's"
                                 " loss or gradient differs from the plain"
                                 " epilogue's")
        print(f"main path {dtype} with the epilogue kernel against the plain"
              f" epilogue: loss {float(lk)} equal, gradient equal bit for bit")
        del out, gk, gp, x0


def reset(counters):
    """Set every launch count to 0."""
    for c in counters:
        for key in c:
            c[key] = 0


# The main path's kernels: the forward gather, both sweeps, the epilogue
# after the fused sweep, the write.
MAIN_PATH = ("gather_lattice", "lattice_fused", "lattice_beta_only",
             "lattice_epilogue", "flat_write")


def phase_main(torch, wt, counters, inputs):
    """The main path once, through the public entry points: three calls,
    each with one forward gather."""
    log_probs, labels, xn, yn = inputs
    reset(counters)

    lp = log_probs.detach().requires_grad_()
    loss = wt.rnnt_loss(lp, labels, xn, yn, reduction="mean", gather=True)
    loss.backward()
    lp3 = log_probs.detach().view(N, T, U * V).requires_grad_()
    loss3 = wt.rnnt_loss(lp3, labels, xn, yn, reduction="mean", gather=True)
    loss3.backward()
    with torch.no_grad():
        costs_ng = wt.rnnt_loss(log_probs, labels, xn, yn, gather=True)
    torch.cuda.synchronize()
    launches = launched(counters)
    print(f"main path launches: {launches}")
    missing = [k for k in MAIN_PATH if launches.get(k, 0) < 1]
    if missing or set(launches) - set(MAIN_PATH):
        raise AssertionError(f"main path launched {launches}, its kernels"
                             f" are {MAIN_PATH}")
    if launches["gather_lattice"] != 3:
        raise AssertionError("main path: not one gather launch a call")
    if launches["lattice_epilogue"] != 2:
        raise AssertionError("main path: not one epilogue launch a grad call")
    return launches, loss, lp.grad, loss3, lp3.grad, costs_ng


def check_main(torch, wt, inputs, loss, grad, loss3, grad3, costs_ng):
    """Against impl="scan" on the card.  Costs: rtol 1e-5 (fp32 sums of ~170
    log-probs near -9).  Gradient: max |diff| <= 5e-3 * max |grad|: each
    entry is exp(alpha + lp + beta - ll) with |ll| ~ 1.5e3, where fp32
    rounding of the two sweeps leaves ~1e-3 of absolute error in the
    exponent."""
    log_probs, labels, xn, yn = inputs
    loss, loss3 = loss.detach(), loss3.detach()
    if grad.shape != (N, T, U, V) or grad3.shape != (N, T, U * V):
        raise AssertionError(f"gradient shapes {grad.shape}, {grad3.shape}")
    for name, x in (("loss", loss), ("grad", grad), ("costs_ng", costs_ng)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name} has non-finite values")
    if not (torch.equal(loss, loss3) and torch.equal(grad.view(-1), grad3.view(-1))):
        raise AssertionError("flat 3-D path differs from the 4-D path")

    lp_s = log_probs.detach().requires_grad_()
    loss_s = wt.rnnt_loss(lp_s, labels, xn, yn, reduction="mean", gather=True,
                          impl="scan")
    loss_s.backward()
    loss_s = loss_s.detach()
    costs_s = wt.rnnt_loss(log_probs, labels, xn, yn, impl="scan").detach()
    loss_err = abs(float(loss) - float(loss_s))
    grad_err = float((grad - lp_s.grad).abs().max())
    grad_scale = float(lp_s.grad.abs().max())
    cost_err = float((costs_ng - costs_s).abs().max())
    print(f"main path vs scan: loss {float(loss)} vs {float(loss_s)}"
          f" (abs err {loss_err}); costs no-grad max abs err {cost_err};"
          f" grad max abs err {grad_err} (max |grad| {grad_scale})")
    if loss_err > 1e-5 * abs(float(loss_s)):
        raise AssertionError("loss differs from the scan")
    if not torch.allclose(costs_ng, costs_s, rtol=1e-5, atol=0.0):
        raise AssertionError("no-grad costs differ from the scan")
    if grad_err > 5e-3 * grad_scale:
        raise AssertionError("gradient differs from the scan")
    return grad_err


def check_golden(torch, wt):
    """The golden vectors of the reference test suite, through the port on
    the card (tolerances of tests/test_torch_binding.py)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import golden

    for name, case in sorted(golden.ALL_PADDED_CASES.items()):
        xs = torch.tensor(case["xs"], dtype=torch.float32, device="cuda",
                          requires_grad=True)
        ys, xn, yn = (torch.tensor(case[k], device="cuda") for k in ("ys", "xn", "yn"))
        costs = wt.rnnt_loss(xs, ys, xn, yn, gather=True)
        costs.sum().backward()
        exp_c = torch.tensor(case["expected_costs"], dtype=torch.float32)
        exp_g = torch.tensor(case["expected_grads"], dtype=torch.float32)
        if not (torch.allclose(costs.detach().cpu(), exp_c, rtol=1e-4, atol=2e-5)
                and torch.allclose(xs.grad.cpu(), exp_g, rtol=1e-4, atol=2e-5)):
            raise AssertionError(f"golden case {name} differs")
        print(f"golden {name}: ok")


def chain_floor_ms(t, u, ns):
    """The lattice's dependency chain: T + U - 1 anti-diagonals, one
    dependent logaddexp of `ns` each."""
    return (t + u - 1) * ns * 1e-6


def lattice_work(n, t, u, compute_alpha):
    """(bytes, fp32 operations) the lattice sweep needs: blank and emit read
    once, betas (and alphas) written once, the lengths read; ~8 operations
    (two adds, max, subtract, abs, exp, add, log) a cell and direction."""
    cells, dirs = n * t * u, 2 if compute_alpha else 1
    return (2 + dirs) * cells * 4 + 2 * n * 4, 8 * cells * dirs


def phase_times(torch, wt, cuda_impl, fk, timing, inputs, main_lattice,
                ct, rates, card, lae_ns):
    log_probs, labels, xn, yn = inputs
    blank, emit, xn_l, yn_l = main_lattice
    ct0, ct1, loc_rows = ct
    R = N * T * U
    first = lambda out: out[1].view(-1)[0]  # noqa: E731  one element of betas
    times = {}

    def kernel(name, fn, plain, args, reduce_out, nbytes, nops, iters):
        ms = timing.bench_scalar_chain(fn, args, iters, reduce_out=reduce_out)
        plain_ms = timing.bench_scalar_chain(plain, args, max(2, iters // 4),
                                             reduce_out=reduce_out)
        b_ms, b_by = bound_ms(nbytes, nops, rates)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"time {name}: ms={ms} plain_ms={plain_ms} bound_ms={b_ms}"
              f" bound_by={b_by} [{card}]")

    # lattice: what the recurrence needs, whatever the kernel does
    for name, alpha in (("lattice_fused", True), ("lattice_beta_only", False)):
        kernel(name, cuda_impl.alpha_beta, cuda_impl.alpha_beta_plain,
               (blank, emit, xn_l, yn_l, alpha), first,
               *lattice_work(N, T, U, alpha), 20)
        times[name]["device_ms"] = timing.bench_graph(
            cuda_impl.alpha_beta, (blank, emit, xn_l, yn_l, alpha))
        print(f"device {name} N,T,U={(N, T, U)}: {times[name]['device_ms']} ms"
              f" (CUDA graph, L2 flushed); chain floor"
              f" {chain_floor_ms(T, U, lae_ns)} ms ({T + U - 1} dependent"
              f" logaddexps of {lae_ns} ns) [{card}]")
    times["lattice_epilogue"] = time_epilogue(torch, cuda_impl, timing,
                                              main_lattice, rates, card)
    # write: reads ct0, ct1, loc_rows, writes R*V fp32; 4 operations per element
    kernel("flat_write", fk.flat_grad_write, fk.flat_grad_write_plain,
           (ct0, ct1, loc_rows, 0, V, U * V), lambda d: d.view(-1)[0],
           R * V * 4 + 2 * R * 4 + N * U * 4, R * V * 4, 20)
    times["flat_write"]["device_ms"] = timing.bench_graph(
        fk.flat_grad_write, (ct0, ct1, loc_rows, 0, V, U * V), calls=8)
    print(f"device flat_write N,T,U,V={(N, T, U, V)}:"
          f" {times['flat_write']['device_ms']} ms (CUDA graph) [{card}]")
    times["flat_write"]["sweep"] = write_sweep(torch, card)

    def loss_grad(impl):
        def step(x):
            x = x.detach().requires_grad_()
            loss = wt.rnnt_loss(x, labels, xn, yn, reduction="mean", gather=True,
                                impl=impl)
            loss.backward()
            return loss.detach(), x.grad
        return step

    e2e = {}
    for impl, iters in (("cuda", 20), ("scan", 4)):
        e2e[impl] = timing.bench_grad_chain(loss_grad(impl), log_probs, iters)
    with torch.no_grad():
        e2e["cuda_no_grad"] = timing.bench_scalar_chain(
            lambda x: wt.rnnt_loss(x, labels, xn, yn, gather=True), (log_probs,), 20
        )
    # end to end: the gather reads the blank and label log-prob of each row
    # (not the whole log-probs), the write stores the gradient once
    e2e_bound, _ = bound_ms(R * V * 4 + 2 * R * 4, 0, rates)
    print(f"time loss+grad (kernels): ms={e2e['cuda']} bound_ms={e2e_bound}"
          f" bound_by=bytes [{card}]")
    print(f"time loss+grad (impl=scan): ms={e2e['scan']} [{card}]")
    print(f"time loss no-grad (kernels): ms={e2e['cuda_no_grad']} [{card}]")
    return times


# The epilogue's timed lattices beside the main path's: the README table's
# long-lattice row (T=1500, 300 labels) at N=128.
EPILOGUE_TIMED = {"T=1500 N=128": (128, 1500, 301)}


def time_epilogue(torch, cuda_impl, timing, main_lattice, rates, card):
    """The epilogue as the main path runs it (the interleaved fp32 lattice
    in, the interleaved fp32 gradient out) at the main path's lattice and
    at `EPILOGUE_TIMED`: chained ms beside the plain version's, device ms
    (CUDA graph, L2 flushed) and the byte bound (`epilogue_bytes`)."""
    def run(fn):
        def call(lat, alphas, betas, xn, yn, g):
            return fn(lat[..., 0], lat[..., 1], alphas, betas, xn, yn, 0.0,
                      g[..., 0], g[..., 1])
        return call

    first = lambda out: out[0][0]  # noqa: E731  one cost
    out = {}
    blank, emit, xn, yn = main_lattice
    shapes = {"main": (blank, emit, xn, yn)}
    for label, (n, t, u) in EPILOGUE_TIMED.items():
        b, e = random_lattice(torch, n, t, u, SEED + 7)
        shapes[label] = (b, e, *seeded_lengths(torch, n, t, u, SEED + 7))
    for label, (b, e, xn_l, yn_l) in shapes.items():
        lat = torch.stack([b, e], dim=-1)
        alphas, betas = cuda_impl.alpha_beta(lat[..., 0], lat[..., 1], xn_l,
                                             yn_l)
        g = torch.empty_like(lat)
        args = (lat, alphas, betas, xn_l, yn_l, g)
        n, t, u = b.shape
        iters = 20 if label == "main" else 5
        r = dict(
            ms=timing.bench_scalar_chain(run(cuda_impl.epilogue), args, iters,
                                         reduce_out=first),
            plain_ms=timing.bench_scalar_chain(run(cuda_impl.epilogue_plain),
                                               args, max(2, iters // 4),
                                               reduce_out=first),
            device_ms=timing.bench_graph(run(cuda_impl.epilogue), args,
                                         calls=32 if label == "main" else 4))
        r["bound_ms"], r["bound_by"] = bound_ms(epilogue_bytes(n, t, u, 4), 0,
                                                rates)
        print(f"time lattice_epilogue {label} N,T,U={(n, t, u)}: {json.dumps(r)}"
              f" [{card}]")
        out[label] = r
        del lat, alphas, betas, g, args
    main = out.pop("main")
    return {**main, **out}


def write_sweep(torch, card):
    """The write over V in {28, 50, 131, 1024, 5000}, fp32 and bf16, at a
    2 GB output (`benchmarks/write_sweep.py`): chained and device ms beside
    the byte bound and one `zero_()` of the output's shape and dtype."""
    from warp_rnnt_tpu_torch.benchmarks import write_sweep as ws

    torch.cuda.empty_cache()
    out = {}
    for r in ws.sweep():
        print(f"time flat_write sweep V={r['V']} {r['dtype']} N={r['N']}:"
              f" {json.dumps(r)}; bound share"
              f" {r['bound_ms'] / r['device_ms']:.3f}, zero_ share"
              f" {r['zero_device_ms'] / r['device_ms']:.3f} [{card}]")
        out[f"V={r['V']} {r['dtype']}"] = {
            k: r[k] for k in ("N", "ms", "device_ms", "bound_ms", "bound_by",
                              "zero_ms", "zero_device_ms", "library_ms")}
    return out


def fj_tree(np, seed, F=FJ["F"], H=FJ["H"], V=FJ["V"]):
    """A Flax-layout joint tree {"params": {"pre", "out"}} of numpy arrays at
    the given widths (the fused slice's by default), lecun-normal kernels
    and small biases, from a seed."""
    rng = np.random.RandomState(seed)

    def dense(fan_in, fan_out):
        return {"kernel": (rng.randn(fan_in, fan_out) / np.sqrt(fan_in)
                           ).astype(np.float32),
                "bias": (0.1 * rng.randn(fan_out)).astype(np.float32)}

    return {"params": {"pre": dense(F, H), "out": dense(H, V)}}


def fj_inputs(torch, seed):
    """Encoder/predictor outputs f (N, T, F), g (N, U, F), labels (N, U-1)
    in [1, V), full lengths, on the card."""
    N, T, U, V, F = (FJ[k] for k in "NTUVF")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn(N, T, F, generator=gen, device="cuda")
    g = torch.randn(N, U, F, generator=gen, device="cuda")
    labels = torch.randint(1, V, (N, U - 1), generator=gen, device="cuda",
                           dtype=torch.int32)
    xn = torch.full((N,), T, dtype=torch.int32, device="cuda")
    yn = torch.full((N,), U - 1, dtype=torch.int32, device="cuda")
    return f, g, labels, xn, yn


def phase_fused_kernels(torch, fj, cases_mod, full_case):
    """Each fused-joint kernel against its plain version, both on the card
    (so both round h from the same tanhf), by `fused_joint_cases.compare`:
    forward at atol 1e-4 on valid frames and finite everywhere; backward
    within 1e-3 of the largest plain entry, d_W and d_b per column group
    (blank, label, other columns, each against its own largest entry)."""
    cases = {name: cases_mod.kernel_case(*case)
             for name, case in cases_mod.KERNEL_CASES.items()}
    cases["full_width"] = full_case
    errs = {}
    for name, (ops, cot) in cases.items():
        a, c, w = ops[:3]
        blank = int(ops[4][0, -1])
        readings = cases_mod.compare(fj, ops, cot, blank)
        torch.cuda.synchronize()
        shape = (*a.shape[:2], c.shape[1], *w.shape[::-1])
        print(f"fused joint kernels {name} N,T,U,V,H={shape} blank={blank}:"
              f" {json.dumps(readings)}")
        if name == "full_width":
            errs = {k: cases_mod.max_err(r) for k, r in readings.items()}
    return errs


def fj_full_case(torch, fj, fjin, params):
    """The full-width kernel operands: a, c from the slice's own
    pre-projection, random lattice cotangents."""
    f, g, labels, xn, yn = fjin
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext

    with torch.no_grad():
        a, c = fj._project(f, g, params)
    lab = _labels_ext(labels, 0)
    gen = torch.Generator(device="cuda").manual_seed(24)
    N, T, U = f.shape[0], f.shape[1], g.shape[1]
    db = torch.randn(N, T, U, generator=gen, device="cuda") / N
    de = torch.randn(N, T, U, generator=gen, device="cuda") / N
    return (a, c, params["w_out"], params["b_out"], lab, xn, yn), (db, de)


FJ_PATH = ("fused_joint_fwd", "fused_joint_bwd_dadc", "fused_joint_bwd_dwdb",
           "lattice_fused", "lattice_beta_only", "lattice_epilogue")


def phase_fused_main(torch, wt, counters, fjin, params):
    """The fused slice once through the public entry point: loss+grad
    (reduction="mean") into f, g and the four parameters, the per-sample
    costs in grad mode, and the no-grad costs."""
    f, g, labels, xn, yn = fjin
    reset(counters)
    fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn, reduction="mean")
    loss.backward()
    costs_g = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn)
    with torch.no_grad():
        costs_ng = wt.rnnt_loss_fused_joint(f, g, params, labels, xn, yn)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if k in FJ_PATH}
    print(f"fused path launches: {launches}")
    missing = [k for k in FJ_PATH if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"fused path never launched: {missing}")
    grads = {"f": fr.grad, "g": gr.grad, **{k: v.grad for k, v in pr.items()}}
    return launches, loss.detach(), grads, costs_g.detach(), costs_ng


def check_fused_main(torch, wt, cases_mod, joint, fjin, loss, grads, costs_g,
                     costs_ng):
    """Against the port's unfused Joint(normalize=True) -> rnnt_loss(gather)
    on the card, with the same carried weights.  The module rounds its
    pre-activations and logits to bf16 (as Flax's Dense(dtype=bf16) does)
    and the fused path keeps fp32 sums, hence loss rtol 2e-3 and each
    gradient within 2e-2 of its largest entry (tests/test_fused_joint.py:
    161-165); w_out and b_out per column group (blank, label, other), each
    against its own largest entry, as in `fused_joint_cases.check_close`.
    No-grad costs equal grad-mode costs at rtol 1e-5."""
    f, g, labels, xn, yn = fjin
    groups = cases_mod.column_groups(labels, 0, FJ["V"])
    fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
    joint.zero_grad(set_to_none=True)
    lp = joint(fr, gr)
    ref = wt.rnnt_loss(lp, labels, xn, yn, reduction="mean", gather=True)
    ref.backward()
    ref = ref.detach()
    ref_grads = {"f": fr.grad, "g": gr.grad,
                 "w_pre": joint.pre.weight.grad.t(), "b_pre": joint.pre.bias.grad,
                 "w_out": joint.out.weight.grad.t(), "b_out": joint.out.bias.grad}
    del lp
    for name, x in (("loss", loss), ("costs", costs_g), ("costs_ng", costs_ng),
                    *grads.items()):
        if not torch.isfinite(x).all():
            raise AssertionError(f"fused {name} has non-finite values")
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    print(f"fused vs unfused: loss {float(loss)} vs {float(ref)} (rel err {rel})")
    if rel > 2e-3:
        raise AssertionError("fused loss differs from the unfused composition")
    for name, got in grads.items():
        readings = cases_mod.check_close(
            f"fused vs unfused grad {name}", got, ref_grads[name].float(), 2e-2,
            groups if name in ("w_out", "b_out") else None)
        print(f"fused vs unfused grad {name}: (max abs err, max |ref|)"
              f" {json.dumps(readings)}")
    if not torch.allclose(costs_ng, costs_g, rtol=1e-5, atol=0.0):
        raise AssertionError("fused no-grad costs differ from grad-mode costs")
    print(f"fused no-grad vs grad-mode costs: max abs err"
          f" {float((costs_ng - costs_g).abs().max())}")


def time_fused_kernels(torch, fj, timing, full_case, rates, card, tag=""):
    """Each fused kernel and its plain version (CUDA events, chained), its
    bound by bf16 tensor-core operations, on the operands of ``full_case``,
    and beside the forward one bf16 torch.matmul of the same (R, H) x (H,
    V) (`time_matmul`); past one slice (H > 256) also the h image kernel,
    chained, on the device and its host us (`h_image.times`), bound by its
    bytes at the unpadded H, with the tanhf it evaluates printed beside."""
    from warp_rnnt_tpu_torch.benchmarks import h_image as hi

    (a, c, w, b, lab, xn, yn), (db, de) = full_case
    N, T, H = a.shape
    U, V = c.shape[1], w.shape[1]
    R = N * T * U
    blank = 0
    bl, el, logz = fj.joint_lattice_fwd(a, c, w, b, lab, xn, yn, blank)
    ops_k, lat, dims, _ = fj._bwd_operands(a, c, w, b, lab, xn, logz, db, de,
                                           blank)
    image = dims[5] > 1  # the h image kernel runs
    h16 = fj._hidden_image(ops_k[0], ops_k[1], xn, dims) if image else None
    _, _, h16 = fj._bwd_dadc(ops_k, lab, xn, lat, dims, blank, h16)
    args = (a, c, w, b, lab, xn, yn, logz, db, de, blank)
    first = lambda out: out[0].view(-1)[0]  # noqa: E731
    prod = 2 * R * H * V  # one R x H x V product
    # bytes: a, c fp32, W bf16, b fp32, labels in; three lattices out (fwd),
    # or three lattices in and the gradients out (bwd)
    io_in = (N * T * H + N * U * H) * 4 + H * V * 2 + V * 4 + N * U * 4
    runs = [
        ("fused_joint_fwd",
         lambda *x: fj._fwd_launch(ops_k, lab, xn, dims, blank, h16),
         fj.joint_lattice_fwd_plain, (a, c, w, b, lab, xn, yn, blank),
         io_in + 3 * R * 4, prod, BF16),
        ("fused_joint_bwd_dadc",
         lambda *x: fj._bwd_dadc(ops_k, lab, xn, lat, dims, blank, h16),
         fj.bwd_dadc_plain, args, io_in + 3 * R * 4 + (N * T + N * U) * H * 4,
         2 * prod, BF16),
        ("fused_joint_bwd_dwdb",
         lambda *x: fj._bwd_dwdb(h16, ops_k, lab, xn, lat, dims, blank),
         fj.bwd_dwdb_plain, args,
         R * H * 2 + H * V * 2 + V * 4 + 3 * R * 4 + (H * V + V) * 4, 2 * prod,
         BF16),
    ]
    # the h kernel: a, c in, h out as bf16 (counted R x H, unpadded); an
    # add and a tanh an element
    if image:
        runs.append(("fused_joint_hidden", None,
                     lambda *x: fj.hidden_image_plain(*x, dims[5]),
                     (ops_k[0], ops_k[1], xn), hi.bound_bytes(N, T, U, H),
                     2 * R * H, 1))
    times = {}
    for name, fn, plain, fargs, nbytes, nops, rate in runs:
        extra = ""
        if fn is None:  # the h image: also its host's share of a chained call
            t = hi.times(*fargs, dims)
            extra = f" tanhf={hi.tanhf(xn, U, dims[3])}"
        else:
            t = dict(ms=timing.bench_scalar_chain(fn, fargs, 10,
                                                  reduce_out=first))
        if name == "fused_joint_fwd":  # without the host (the V parts' merge)
            t["device_ms"] = timing.bench_graph(fn, fargs)
        plain_ms = timing.bench_scalar_chain(plain, fargs, 2, repeats=1,
                                             reduce_out=first)
        b_ms, b_by = bound_ms(nbytes, nops, rates, rate)
        times[name] = dict(t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"time {name}{tag}: {json.dumps(times[name])}{extra}"
              f" ({b_ms / t['ms']:.3f} of the bound) [{card}]")
    times["fused_joint_fwd"]["matmul_ms"] = time_matmul(torch, timing, rates,
                                                        card, R, H, V)
    return times


def peak_and_time(torch, timing, step, x0, iters):
    """(ms per call, peak device bytes above what was allocated before) of a
    loss+grad step, chain-timed on its own gradient."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(x0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return timing.bench_grad_chain(step, x0, iters), peak


def phase_fused_times(torch, wt, fj, timing, joint, fjin, params, full_case,
                      rates, card):
    """The fused kernels' times (`time_fused_kernels`); then fused and
    unfused loss+grad end to end, each with its peak device memory."""
    N, T, U, V, H = (FJ[k] for k in "NTUVH")
    prod = 2 * N * T * U * H * V  # one R x H x V product
    times = time_fused_kernels(torch, fj, timing, full_case, rates, card)

    f, g, labels, xn, yn = fjin
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}

    def fused_step(x):
        x = x.detach().requires_grad_()
        for p in pr.values():
            p.grad = None
        loss = wt.rnnt_loss_fused_joint(x, g, pr, labels, xn, yn,
                                        reduction="mean")
        loss.backward()
        return loss.detach(), x.grad

    def unfused_step(x):
        x = x.detach().requires_grad_()
        joint.zero_grad(set_to_none=True)
        loss = wt.rnnt_loss(joint(x, g), labels, xn, yn, reduction="mean",
                            gather=True)
        loss.backward()
        return loss.detach(), x.grad

    e2e = {}
    for name, step in (("fused", fused_step), ("unfused", unfused_step)):
        ms, peak = peak_and_time(torch, timing, step, f, 10)
        e2e[name] = (ms, peak)
        print(f"time loss+grad {name} joint: ms={ms} peak_mem_bytes={peak}"
              f" ({peak / 2**30:.3f} GiB above the inputs) [{card}]")
    with torch.no_grad():
        ng = timing.bench_scalar_chain(
            lambda x: wt.rnnt_loss_fused_joint(x, g, params, labels, xn, yn),
            (f,), 10)
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step

    for name, step in (("fused", fused_step), ("unfused", unfused_step)):
        prof = profile_step(lambda: step(f))
        print(f"profile loss+grad {name} joint: {prof['kernels_per_call']}"
              f" kernels a call, idle share {prof['idle_share']}, device busy"
              f" {prof['busy_ms']} ms, wall {prof['wall_ms']} ms [{card}]")
        for ms, count, key in prof["rows"][:12]:
            print(f"profile {name} {ms:.4f} ms/call {count} x/call {key[:80]}")
    # the least the fused loss+grad needs: forward product + the backward's
    # three (logits, dh, dW)
    e2e_bound, _ = bound_ms(0, 4 * prod, rates, BF16)
    print(f"time loss+grad fused joint bound_ms={e2e_bound} bound_by=operations"
          f" [{card}]")
    print(f"time loss no-grad fused joint: ms={ng} [{card}]")
    return times

# ---- slice 3: the compact layout, rnnt_loss_joint, LLM-size vocabularies --

# Random lengths as `bench_joint.py` draws them (xn in [T/2, T], yn in
# [L/2, L] labels, numpy seed 0).  A: warp-rnnt's headline shape; B: the
# long-lattice, small-vocabulary shape of the JAX package's RESULTS.md:57.
CASE_A = dict(N=32, T=150, L=20, V=5000)
CASE_B = dict(N=16, T=1500, L=300, V=50)
# The joint layouts: bench_joint.py:45's configuration, and the shapes the
# CUDA auto route rests on beside it: V=28 (T=150, 40 labels;
# RESULTS.md:55), V=256 and V=1000 between the two.
JL = dict(N=16, T=150, L=20, V=5000, H=256, F=256)
JL_SWEEP = (dict(N=16, T=150, L=40, V=28, H=256, F=256),
            dict(N=16, T=150, L=20, V=256, H=256, F=256),
            dict(N=16, T=150, L=20, V=1000, H=256, F=256))
# The fused joint at LLM-size vocabularies, full lengths.
LARGE_V = {"V=64000": dict(N=2, T=150, U=21, V=64000, H=256, F=256),
           "V=50257": dict(N=1, T=150, U=21, V=50257, H=256, F=256)}

COMPACT_PATH = ("packed_gather", "packed_scatter", "lattice_fused",
                "lattice_beta_only", "lattice_epilogue")
JOINT_PATHS = {"padded": ("lattice_fused", "lattice_beta_only",
                          "lattice_epilogue"),
               "compact": COMPACT_PATH, "fused": FJ_PATH}


def launched(counters):
    return {k: v for c in counters for k, v in c.items() if v}


def phase_packed_kernels(torch, pk, pc, full_cases):
    """Each packed kernel against its plain version on the card, bit for
    bit (`packed_cases.compare`: the gather entry's lattice, loc and prefix
    sums, and the scatter from them): the JAX package's edge cases (ragged,
    one sample, yn=0, T over many rows, T < U, pad rows, blank=3, V in
    {5, 9, 13, 33, 50}, every input dtype), the NaN rule (a short buffer,
    labels outside [0, V)), then cases A and B."""
    cases = {name: pc.make_case(xn, yn, V, pad, blank, dt, 0, "cuda")
             for name, (xn, yn, V, pad, blank, dt) in pc.CASES.items()}
    cases["NaN rule"] = pc.nan_case("cuda")
    cases.update(full_cases)
    errs = {"packed_gather": 0.0, "packed_scatter": 0.0}
    for name, case in cases.items():
        r = pc.compare(pk, case)
        torch.cuda.synchronize()
        print(f"packed kernels {name} rows,V={tuple(case['xs'].shape)}"
              f" {case['xs'].dtype}: {r}")
        errs = {k: max(errs[k], r[k]) for k in errs}
    return errs


def phase_compact(torch, wt, counters, case, label):
    """The compact path once through the public entry point: loss+grad
    (reduction="mean"), the grad-mode per-sample costs and the no-grad
    costs.  Every kernel of the path must have run."""
    xs, ys, xn, yn = (case[k] for k in ("xs", "ys", "xn", "yn"))
    reset(counters)
    x = xs.detach().requires_grad_()
    loss = wt.rnnt_loss(x, ys, xn, yn, compact=True, reduction="mean")
    loss.backward()
    costs_g = wt.rnnt_loss(x, ys, xn, yn, compact=True)
    with torch.no_grad():
        costs_ng = wt.rnnt_loss(xs, ys, xn, yn, compact=True)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if k in COMPACT_PATH}
    print(f"compact path {label} launches: {launches}")
    missing = [k for k in COMPACT_PATH if launches[k] < 1]
    if missing:
        raise AssertionError(f"compact path {label} never launched: {missing}")
    return launches, loss.detach(), x.grad, costs_g.detach(), costs_ng


def padded_from_packed(torch, pk, case):
    """The packed values scattered into (N, T, U, V) (zeros elsewhere), the
    (N, U-1) labels, and the packed rows' cells (n, t, u) and valid count."""
    xs, xn, yn = case["xs"], case["xn"], case["yn"]
    N, T, U, V = xn.shape[0], case["T"], case["U"], xs.shape[1]
    n, t, u, valid = pk.row_coordinates(xs.shape[0], xn, yn)
    nv = int(valid.sum())
    n, t, u = n[:nv], t[:nv], u[:nv]
    padded = torch.zeros((N, T, U, V), dtype=xs.dtype, device=xs.device)
    padded[n, t, u] = xs[:nv]
    return padded, case["loc"][:, :-1].contiguous(), (n, t, u, nv)


def check_compact(torch, wt, pk, case, label, loss, grad, costs_g, costs_ng):
    """Against the padded port on the same values: the two give the same
    lattice to the same kernels, so costs agree to rtol 1e-6 (bit for bit in
    practice), the packed gradient equals the padded one at valid cells
    exactly and is 0 on pad rows; no-grad costs equal grad-mode costs at
    rtol 1e-5."""
    xn, yn = case["xn"], case["yn"]
    padded, labels, (n, t, u, nv) = padded_from_packed(torch, pk, case)
    p = padded.requires_grad_()
    ref = wt.rnnt_loss(p, labels, xn, yn, reduction="mean", gather=True)
    ref.backward()
    ref = ref.detach()
    costs_p = wt.rnnt_loss(p, labels, xn, yn, gather=True).detach()
    for name, x in (("loss", loss), ("costs", costs_g), ("costs_ng", costs_ng),
                    ("grad", grad)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"compact {label} {name}: non-finite values")
    cost_err = float((costs_g - costs_p).abs().max())
    same_grad = torch.equal(grad[:nv], p.grad[n, t, u])
    pad_zero = bool((grad[nv:] == 0).all())
    print(f"compact vs padded {label}: loss {float(loss)} vs {float(ref)};"
          f" costs max abs err {cost_err}; grads equal at valid cells"
          f" {same_grad}; {grad.shape[0] - nv} pad rows zero {pad_zero};"
          f" no-grad vs grad-mode costs max abs err"
          f" {float((costs_ng - costs_g).abs().max())}")
    if not torch.allclose(costs_g, costs_p, rtol=1e-6, atol=0.0):
        raise AssertionError(f"compact {label}: costs differ from padded")
    if not (same_grad and pad_zero):
        raise AssertionError(f"compact {label}: gradient differs from padded")
    if not torch.allclose(costs_ng, costs_g, rtol=1e-5, atol=0.0):
        raise AssertionError(f"compact {label}: no-grad costs differ")


def joint_inputs(torch, np, dims, seed):
    """f (N, T, F), g (N, L+1, F), labels (N, L) in [1, V), random lengths
    (`bench_joint.py`'s recipe) on the card."""
    N, T, L, V, F = (dims[k] for k in "NTLVF")
    rng = np.random.RandomState(seed)
    xn = rng.randint(T // 2, T + 1, size=N)
    yn = rng.randint(L // 2, L + 1, size=N)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn(N, T, F, generator=gen, device="cuda")
    g = torch.randn(N, L + 1, F, generator=gen, device="cuda")
    labels = torch.randint(1, V, (N, L), generator=gen, device="cuda",
                           dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device="cuda")
    return f, g, labels, torch.tensor(xn, **i32), torch.tensor(yn, **i32)


def joint_step(wt, layout, g, params, labels, xn, yn):
    """A loss+grad step of one layout, chained on f."""
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}

    def step(x):
        x = x.detach().requires_grad_()
        loss = wt.rnnt_loss_joint(x, g, pr, labels, xn, yn, reduction="mean",
                                  layout=layout)
        loss.backward()
        return loss.detach(), x.grad
    return step


def phase_joint_layouts(torch, wt, jl, cases_mod, counters, jin, params):
    """`rnnt_loss_joint` in every layout at JL: loss+grad (reduction="mean")
    into f, g and the four parameters, and the no-grad costs, each layout's
    counts set to 0 just before and read just after.  compact and fused are
    held against padded (loss rtol 2e-3; gradients within 2e-2 of their
    largest entry, w_out and b_out per column group); auto must run the
    route `joint_layout_route` names and equal it exactly."""
    f, g, labels, xn, yn = jin
    route = jl.joint_layout_route(f.shape[1], g.shape[1], JL["H"], JL["V"],
                                  N=f.shape[0], platform="cuda")
    groups = cases_mod.column_groups(labels, 0, JL["V"])
    out = {}
    for layout in ("padded", "compact", "fused", "auto"):
        reset(counters)
        fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
        pr = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = wt.rnnt_loss_joint(fr, gr, pr, labels, xn, yn, reduction="mean",
                                  layout=layout)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            costs_ng = wt.rnnt_loss_joint(f, g, params, labels, xn, yn,
                                          layout=layout)
        torch.cuda.synchronize()
        grads = {"f": fr.grad, "g": gr.grad, **{k: v.grad for k, v in pr.items()}}
        launches = launched(counters)
        want = JOINT_PATHS[route if layout == "auto" else layout]
        print(f"joint layout {layout} launches: {launches}")
        if [k for k in want if k not in launches] or set(launches) - set(want):
            raise AssertionError(f"joint layout {layout}: launched {launches},"
                                 f" its path is {want}")
        for name, x in (("loss", loss), ("costs_ng", costs_ng), *grads.items()):
            if not torch.isfinite(x).all():
                raise AssertionError(f"joint {layout} {name}: non-finite")
        rel = abs(float(costs_ng.mean()) - float(loss)) / abs(float(loss))
        if rel > 1e-5:
            raise AssertionError(f"joint {layout}: no-grad costs differ ({rel})")
        out[layout] = (launches, loss, grads)
    ref_loss, ref_grads = out["padded"][1], out["padded"][2]
    for layout in ("compact", "fused"):
        loss, grads = out[layout][1], out[layout][2]
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        print(f"joint {layout} vs padded: loss {float(loss)} vs"
              f" {float(ref_loss)} (rel err {rel})")
        if rel > 2e-3:
            raise AssertionError(f"joint {layout}: loss differs from padded")
        for name, got in grads.items():
            r = cases_mod.check_close(
                f"joint {layout} vs padded grad {name}", got, ref_grads[name],
                2e-2, groups if name in ("w_out", "b_out") else None)
            print(f"joint {layout} vs padded grad {name}: {json.dumps(r)}")
    loss, grads = out["auto"][1], out["auto"][2]
    ref_loss, ref_grads = out[route][1], out[route][2]
    if not torch.equal(loss, ref_loss):
        raise AssertionError(f"auto ({route}) loss differs from {route}")
    for name, got in grads.items():
        cases_mod.check_close(f"auto grad {name}", got, ref_grads[name], 1e-6)
    print(f"joint auto routes to {route} at V={JL['V']} and equals it")
    return route


def phase_large_v(torch, np, wt, fj, cases_mod, carry, counters):
    """The fused kernels against their plain versions at V=64000 and
    V=50257 (1e-3 per column group, `fused_joint_cases.compare`), then
    `rnnt_loss_fused_joint` at V=64000 once (loss+grad and no-grad costs,
    counts set to 0 just before), held against the padded layout of
    `rnnt_loss_joint` (loss rtol 2e-3, gradients 2e-2, w_out and b_out per
    column group).  Returns (kernel errs, launches, V=64000 operands,
    {"V=50257": kernel operands})."""
    errs, keep, fulls = {}, None, {}
    for name, d in LARGE_V.items():
        _, params = carry(fj_tree(np, SEED + 3, d["F"], d["H"], d["V"]),
                          device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        f = torch.randn(d["N"], d["T"], d["F"], generator=gen, device="cuda")
        g = torch.randn(d["N"], d["U"], d["F"], generator=gen, device="cuda")
        labels = torch.randint(1, d["V"], (d["N"], d["U"] - 1), generator=gen,
                               device="cuda", dtype=torch.int32)
        i32 = dict(dtype=torch.int32, device="cuda")
        xn = torch.full((d["N"],), d["T"], **i32)
        yn = torch.full((d["N"],), d["U"] - 1, **i32)
        jin = (f, g, labels, xn, yn)
        full = fj_full_case(torch, fj, jin, params)
        ops, cot = full
        readings = cases_mod.compare(fj, ops, cot, 0)
        torch.cuda.synchronize()
        print(f"fused joint kernels {name} N,T,U,V,H="
              f"{(d['N'], d['T'], d['U'], d['V'], d['H'])}: {json.dumps(readings)}")
        errs[name] = {k: cases_mod.max_err(r) for k, r in readings.items()}
        if keep is None:
            keep = (jin, params, full)
        else:
            fulls[name] = full
    jin, params, full = keep
    f, g, labels, xn, yn = jin
    reset(counters)
    fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn, reduction="mean")
    loss.backward()
    loss = loss.detach()
    with torch.no_grad():
        costs_ng = wt.rnnt_loss_fused_joint(f, g, params, labels, xn, yn)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if k in FJ_PATH}
    print(f"fused path V=64000 launches: {launches}")
    missing = [k for k in FJ_PATH if launches[k] < 1]
    if missing:
        raise AssertionError(f"fused path V=64000 never launched: {missing}")
    grads = {"f": fr.grad, "g": gr.grad, **{k: v.grad for k, v in pr.items()}}
    fr2, gr2 = f.detach().requires_grad_(), g.detach().requires_grad_()
    pr2 = {k: v.detach().requires_grad_() for k, v in params.items()}
    ref = wt.rnnt_loss_joint(fr2, gr2, pr2, labels, xn, yn, reduction="mean",
                             layout="padded")
    ref.backward()
    ref = ref.detach()
    ref_grads = {"f": fr2.grad, "g": gr2.grad,
                 **{k: v.grad for k, v in pr2.items()}}
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    print(f"fused V=64000 vs padded: loss {float(loss)} vs {float(ref)}"
          f" (rel err {rel}); no-grad mean {float(costs_ng.mean())}")
    if rel > 2e-3 or abs(float(costs_ng.mean()) - float(loss)) > 1e-5 * abs(
            float(loss)):
        raise AssertionError("fused V=64000: loss differs")
    groups = cases_mod.column_groups(labels, 0, LARGE_V["V=64000"]["V"])
    for name, got in grads.items():
        r = cases_mod.check_close(
            f"fused V=64000 vs padded grad {name}", got, ref_grads[name], 2e-2,
            groups if name in ("w_out", "b_out") else None)
        print(f"fused V=64000 vs padded grad {name}: {json.dumps(r)}")
    return errs, launches, keep, fulls


def time_packed_kernels(torch, pk, timing, case, rates, card, tag):
    """Each packed kernel and its plain version at one full-width case:
    chained, device (CUDA graph) and host-us times
    (`packed_step.movement_times`) beside its byte bound (the entries the
    function must read and write, `packed_step.gather_bytes` for the
    gather); the gather's sector floors (`packed_step.floors`) are printed
    beside them."""
    from warp_rnnt_tpu_torch.benchmarks import packed_step as ps

    xs, ys, xn, yn = case["xs"], case["ys"], case["xn"], case["yn"]
    T, U, blank = case["T"], case["U"], case["blank"]
    N = xn.shape[0]
    rows, V = xs.shape
    size = xs.element_size()
    cells = N * T * U
    meta = N * U * 4 + 2 * N * 4 + 16 * N
    _, loc, pref = pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)
    fwd, bwd = ps.movement(case)
    times = {}
    for name, fn, plain, args, nbytes, nops, red, extra in (
        ("packed_gather", fwd, pk.packed_gather_lattice_plain,
         (xs, ys, xn, yn, blank, T, U), ps.gather_bytes(case), 0,
         lambda out: out[0].view(-1)[0], ps.floors(case, rates[0])),
        ("packed_scatter", bwd, pk.packed_scatter_plain,
         (case["ct"], loc, pref, xn, yn, blank, rows, V, xs.dtype),
         rows * V * size + 2 * cells * 4 + meta, rows * V * 4,
         lambda out: out.view(-1)[0], {}),
    ):
        plain_ms = timing.bench_scalar_chain(plain, args, 4, repeats=1,
                                             reduce_out=red)
        b_ms, b_by = bound_ms(nbytes, nops, rates)
        times[name] = dict(ps.movement_times(fn, xs), plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by)
        print(f"time {name} {tag}: {json.dumps(times[name])}"
              f"{' ' + json.dumps(extra) if extra else ''} [{card}]")
    return times


def time_compact(torch, wt, pk, cuda_impl, timing, case, rates, card, tag,
                 lae_ns):
    """Compact loss+grad and no-grad against padded loss+grad on the same
    values, each with its peak device memory (the reference's
    compact-vs-padded comparison).  Beside them: the lattice kernels at the
    case's lattice with their bound and chain floor, and compact loss+grad
    with the host read of the lengths (`compact._static_bounds`) left out,
    which shows what that read costs."""
    from warp_rnnt_tpu_torch.benchmarks import packed_step as ps
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
    from warp_rnnt_tpu_torch.functional.core import rnnt_core

    xs, ys, xn, yn = (case[k] for k in ("xs", "ys", "xn", "yn"))
    T, U, blank = case["T"], case["U"], case["blank"]
    lat = pk.packed_gather_lattice(xs, ys, xn, yn, blank, T, U)[0]
    blank_lp, emit_lp = lat[..., 0].contiguous(), lat[..., 1].contiguous()
    del lat
    lattice = {}
    for name, alpha in (("lattice_fused", True), ("lattice_beta_only", False)):
        ms = timing.bench_scalar_chain(
            cuda_impl.alpha_beta, (blank_lp, emit_lp, xn, yn, alpha), 10,
            reduce_out=lambda out: out[1].view(-1)[0])
        dev = timing.bench_graph(cuda_impl.alpha_beta,
                                 (blank_lp, emit_lp, xn, yn, alpha))
        b_ms, b_by = bound_ms(*lattice_work(*blank_lp.shape, alpha), rates)
        floor = chain_floor_ms(T, U, lae_ns)
        lattice[name] = dict(ms=ms, device_ms=dev, bound_ms=b_ms,
                             bound_by=b_by)
        print(f"time {name} {tag} N,T,U={tuple(blank_lp.shape)}: ms={ms}"
              f" device_ms={dev} bound_ms={b_ms} bound_by={b_by}"
              f" chain_floor_ms={floor} [{card}]")
    del blank_lp, emit_lp

    def no_read_step(x):
        x = x.detach().requires_grad_()
        lat = pk.packed_lattice(x, ys, xn, yn, blank, T, U)
        loss = rnnt_core(lat, xn, yn, 0.0, "auto").mean()
        loss.backward()
        return loss.detach(), x.grad

    padded, labels, _ = padded_from_packed(torch, pk, case)
    compact_step = ps.loss_grad_step(case)

    def padded_step(x):
        x = x.detach().requires_grad_()
        loss = wt.rnnt_loss(x, labels, xn, yn, reduction="mean", gather=True)
        loss.backward()
        return loss.detach(), x.grad

    out = {}
    for name, step, x0 in (("compact", compact_step, xs),
                           ("compact without the host read", no_read_step, xs),
                           ("padded", padded_step, padded)):
        ms, peak = peak_and_time(torch, timing, step, x0, 10)
        out[name] = dict(ms=ms, peak_mem_bytes=peak)
        print(f"time loss+grad {name} {tag}: ms={ms} peak_mem_bytes={peak}"
              f" ({peak / 2**30:.3f} GiB above the inputs) [{card}]")
    ng = ps.no_grad_ms(case, 10)
    out["compact_no_grad_ms"] = ng
    out["lattice"] = lattice
    print(f"time loss no-grad compact {tag}: ms={ng} [{card}]")
    prof = profile_step(lambda: compact_step(xs))
    out["profile"] = {k: prof[k] for k in ("kernels_per_call", "busy_ms",
                                           "idle_share", "step_ms")}
    print(f"profile compact {tag}: {json.dumps(out['profile'])} [{card}]")
    for ms, count, key in prof["rows"][:8]:
        print(f"profile compact {tag} {ms:.4f} ms/call {count} x/call {key[:70]}")
    return out


def time_joint_layouts(torch, wt, timing, jin, params, layouts, card, tag):
    """Each layout's loss+grad with its peak device memory, chained on f."""
    f, g, labels, xn, yn = jin
    out = {}
    for layout in layouts:
        step = joint_step(wt, layout, g, params, labels, xn, yn)
        ms, peak = peak_and_time(torch, timing, step, f, 8)
        out[layout] = dict(ms=ms, peak_mem_bytes=peak)
        print(f"time loss+grad joint {layout} {tag}: ms={ms}"
              f" peak_mem_bytes={peak} ({peak / 2**30:.3f} GiB above the"
              f" inputs) [{card}]")
    return out


def time_large_v(torch, wt, fj, timing, keep, rates, card):
    """The fused kernels and fused loss+grad at V=64000."""
    jin, params, full = keep
    times = time_fused_kernels(torch, fj, timing, full, rates, card,
                               " V=64000")
    f, g, labels, xn, yn = jin
    pr = {k: v.detach().requires_grad_() for k, v in params.items()}

    def step(x):
        x = x.detach().requires_grad_()
        loss = wt.rnnt_loss_fused_joint(x, g, pr, labels, xn, yn,
                                        reduction="mean")
        loss.backward()
        return loss.detach(), x.grad

    ms, peak = peak_and_time(torch, timing, step, f, 6)
    d = LARGE_V["V=64000"]
    b_ms, _ = bound_ms(0, 8 * d["N"] * d["T"] * d["U"] * d["H"] * d["V"], rates,
                       BF16)
    print(f"time loss+grad fused joint V=64000: ms={ms} peak_mem_bytes={peak}"
          f" bound_ms={b_ms} bound_by=operations [{card}]")
    ms, peak = peak_and_time(
        torch, timing, joint_step(wt, "padded", g, params, labels, xn, yn), f, 6)
    print(f"time loss+grad joint padded V=64000: ms={ms} peak_mem_bytes={peak}"
          f" [{card}]")
    return times

# ---- slice 4: the gather experiments' kernels, the main path at 7.5-9 GB ---

# N=32: 2.02 GB of log-probs; N=128: 7.5 GiB, the JAX experiments' shape;
# N=144: 9.07 GB, 2.27e9 elements, past 2^31.
GATHER_N = (32, 128, 144)
GATHER_PATH = ("gather_columns", "gather_fwd", "gather_fwd_sparse",
               "gather_lattice", "flat_write")


def phase_gather_kernels(torch, gk, gc, gather_plain):
    """(a) Each gather kernel and `scatter_bwd` against its plain version
    on the card, exact (`gather_cases.compare`; labels at -1, V + 7 and the
    blank, in fp32, bf16, fp16 and fp64), and the lattice kernel against
    the main path's plain formulation where the labels are in range
    (`gather_cases.main_path_lattice`)."""
    errs = dict.fromkeys(GATHER_PATH, 0.0)
    for name, (n, t, u, v, blank, dtype, k) in gc.CASES.items():
        case = gc.make_case(n, t, u, v, blank, dtype, k, device="cuda")
        r = gc.compare(gk, case)
        gc.main_path_lattice(gk, gather_plain, case)
        torch.cuda.synchronize()
        print(f"gather kernels {name} N,T,U,V={(n, t, u, v)} K={k}"
              f" blank={blank} {dtype}: {r}")
        errs = {key: max(errs[key], r[key]) for key in errs}
    return errs


def phase_gather_path(torch, eg, counters):
    """The slice's path once: `exp_gather`'s kernel, stream, sparse,
    lattice and scatter variants at N=32, each held against the plain
    gather, with the counts set to 0 just before and read just after."""
    d = eg.make(N, "cuda", SEED)
    ref = eg.reference(d)
    reset(counters)
    for variant in ("kernel", "stream", "sparse", "lattice", "scatter"):
        eg.check(variant, d, ref)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if k in GATHER_PATH}
    print(f"gather path launches: {launches}")
    missing = [k for k in GATHER_PATH if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"gather path never launched: {missing}")
    return launches


def time_gathers(torch, eg, gk, timing, gather_plain, n, rates, card):
    """(b) The gather wrappers at N=n, each with the one `torch.gather`
    call that gives the same values (its int64 index made once outside the
    timing; the library yardstick) and, for the main path's lattice, the
    previous formulation (``gather_plain``: an index cast, a `torch.gather`
    and a stack): all exact against the kernel and its plain version.
    Then, in turns (kernel, library, kernel, library): chained ms, device
    ms (graph replay, L2 flushed) and host us per call (`timing.bench_host`,
    the calls queued behind a device-side sleep); the plain version's
    chained ms and the byte bound."""
    d = eg.make(n, "cuda", SEED + n)
    xs, xs3, lab = d["xs"], d["xs3"], d["labels"]
    t, u = xs.shape[1], xs.shape[2]
    cols = gk.blank_label_cols(lab, eg.BLANK, eg.V)
    k = cols.shape[1]
    idx_cols = cols.long()[:, None, :].expand(n, t, k)
    idx4 = torch.stack([torch.full_like(lab, eg.BLANK), lab],
                       dim=-1).long()[:, None].expand(n, t, u, 2)
    runs = {
        "gather_columns": (gk.gather_columns_flat, gk.gather_columns_flat_plain,
                           (xs3, cols), lambda *a: torch.gather(xs3, 2, idx_cols),
                           lambda out: out),
        "gather_fwd": (gk.gather_fwd, gk.gather_fwd_plain, (xs, lab, eg.BLANK),
                       lambda *a: torch.gather(xs, 3, idx4),
                       lambda out: out.permute(1, 2, 3, 0)),
        "gather_fwd_sparse": (gk.gather_fwd_sparse, gk.gather_fwd_sparse_plain,
                              (xs3, lab, eg.BLANK, eg.V),
                              lambda *a: torch.gather(xs3, 2, idx_cols),
                              lambda out: out.transpose(0, 1).reshape(
                                  n, 2 * u, t).transpose(1, 2)),
        "gather_lattice": (gk.gather_lattice, gk.gather_lattice_plain,
                           (xs, lab, eg.BLANK),
                           lambda *a: torch.gather(xs, 3, idx4),
                           lambda out: out),
    }
    first = eg.first_value
    b_ms, b_by = bound_ms(eg.bound_bytes("kernel", n), 0, rates)
    times = {}
    for name, (fn, plain, args, library, as_library) in runs.items():
        got = fn(*args)
        if not torch.equal(got, plain(*args)):
            raise AssertionError(f"{name} N={n}: kernel != plain version")
        if not torch.equal(as_library(got), library()):
            raise AssertionError(f"{name} N={n}: kernel != torch.gather")
        if name == "gather_lattice" and not torch.equal(got, gather_plain(*args)):
            raise AssertionError(f"{name} N={n}: kernel != the previous"
                                 " formulation")
        del got
        r = {}
        for key, measure in (
                ("ms", lambda f: timing.bench_scalar_chain(f, args, 20,
                                                          reduce_out=first)),
                ("device_ms", lambda f: timing.bench_graph(f, args)),
                ("host_us", lambda f: timing.bench_host(f, args))):
            for _ in range(2):
                r.setdefault(f"{key}_readings", []).append(measure(fn))
                r.setdefault(f"library_{key}_readings", []).append(
                    measure(library))
            r[key] = min(r[f"{key}_readings"])
            r[f"library_{key}"] = min(r[f"library_{key}_readings"])
        r["plain_ms"] = timing.bench_scalar_chain(plain, args, 10,
                                                  reduce_out=first)
        if name == "gather_lattice":
            r["previous_ms"] = timing.bench_scalar_chain(gather_plain, args, 20,
                                                         reduce_out=first)
            r["previous_device_ms"] = timing.bench_graph(gather_plain, args)
        r.update(bound_ms=b_ms, bound_by=b_by)
        times[name] = r
        share = b_ms / r["device_ms"] if r["device_ms"] else None
        print(f"time {name} N={n}: {json.dumps(r)} bound_share={share}"
              f" (kernel = plain = torch.gather, exact) [{card}]")
        if r["ms"] > r["library_ms"]:
            print(f"note: {name} N={n} chained {r['ms']} ms > torch.gather"
                  f" {r['library_ms']} ms")
    return times


def time_scatter(torch, eg, gk, timing, n, rates, card):
    """(c) `scatter_bwd` (row 14, the `flat_write` kernel) at N=n against
    its plain version, exact: whole at N=32, and at larger N (where the
    plain version's temporaries are several times the output) on three
    whole samples, the last past 2^31 elements at N=144.  Then its ms."""
    d = eg.make(n, "cuda", SEED + n)
    args = (d["ct_b"], d["ct_l"], d["labels"], eg.BLANK, eg.V)
    out = gk.scatter_bwd(*args)
    samples = [slice(None)] if n == N else [slice(s, s + 1)
                                            for s in (0, n // 2, n - 1)]
    for s in samples:
        want = gk.scatter_bwd_plain(*(a[s] for a in args[:3]), eg.BLANK, eg.V)
        if not torch.equal(out[s], want):
            raise AssertionError(f"scatter_bwd N={n} samples {s}: kernel !="
                                 " plain version")
        del want
    del out
    b_ms, b_by = bound_ms(eg.bound_bytes("scatter", n), 0, rates)
    one = eg.first_value
    r = dict(ms=timing.bench_scalar_chain(gk.scatter_bwd, args, 10,
                                          reduce_out=one),
             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    if n == N:
        r["plain_ms"] = timing.bench_scalar_chain(gk.scatter_bwd_plain, args, 4,
                                                  repeats=1, reduce_out=one)
    print(f"time scatter_bwd (flat_write) N={n}: {json.dumps(r)}; kernel ="
          f" plain on {'all' if n == N else 'samples 0, N/2, N-1'} [{card}]")
    return r


def check_previous_formulation(torch, wt, fk, gather_plain, inputs, loss,
                               grad, tag):
    """The main path's lattice, loss and gradient against the previous
    formulation's on the same card, bit for bit: the plain gather (index
    cast, `torch.gather`, stack) into the pre-gathered loss (blank=-1,
    reduction="mean"), whose lattice gradient the same `flat_write` kernel
    writes densely."""
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext
    from warp_rnnt_tpu_torch.ops import gather_kernels as gk

    log_probs, labels, xn, yn = inputs
    n, t, u, v = log_probs.shape
    lab = _labels_ext(labels, 0)
    lat = gather_plain(log_probs, lab, 0)
    same_lat = torch.equal(gk.gather_lattice(log_probs, lab, 0), lat)
    lat.requires_grad_()
    ref = wt.rnnt_loss(lat, labels, xn, yn, blank=-1, reduction="mean")
    ref.backward()
    ref_grad = fk.flat_grad_write(lat.grad[..., 0].contiguous(),
                                  lat.grad[..., 1].contiguous(), lab, 0, v,
                                  u * v)
    same_loss = torch.equal(loss, ref.detach())
    same_grad = torch.equal(grad.reshape(-1), ref_grad.view(-1))
    print(f"main path {tag} against the previous formulation: lattice equal"
          f" {same_lat}, loss equal {same_loss}, gradient equal {same_grad}")
    if not (same_lat and same_loss and same_grad):
        raise AssertionError(f"main path {tag}: differs from the previous"
                             " formulation")


def phase_big_main(torch, wt, fk, gather_plain, timing, counters, n, rates,
                   card):
    """(d) The main path at N=n, once through the public entry point:
    loss+grad (reduction="mean") on the 4-D input and the no-grad costs,
    counts set to 0 just before and read just after.  Costs against
    impl="scan" on the card (rtol 1e-5); the gradient of samples 0, n/2 and
    n-1 against a one-sample call on the same card (offsets below 2^31,
    cotangent 1/n as the mean's: within 1e-6 of its largest entry, bit for
    bit in practice), and of sample n-1 against the plain CPU path (5e-3
    of its largest entry, the tolerance of `check_main`).  Then loss+grad
    ms and peak memory."""
    log_probs, labels, xn, yn = make_inputs(torch, n, T, U, V, SEED + n)
    reset(counters)
    lp = log_probs.detach().requires_grad_()
    loss = wt.rnnt_loss(lp, labels, xn, yn, reduction="mean", gather=True)
    loss.backward()
    with torch.no_grad():
        costs_ng = wt.rnnt_loss(log_probs, labels, xn, yn, gather=True)
    torch.cuda.synchronize()
    launches = launched(counters)
    print(f"main path N={n} launches: {launches}")
    missing = [k for k in MAIN_PATH if launches.get(k, 0) < 1]
    if missing or set(launches) - set(MAIN_PATH):
        raise AssertionError(f"main path N={n} launched {launches}")
    if launches["gather_lattice"] != 2:
        raise AssertionError(f"main path N={n}: not one gather launch a call")
    grad, loss = lp.grad, loss.detach()
    del lp
    check_previous_formulation(torch, wt, fk, gather_plain,
                               (log_probs, labels, xn, yn), loss, grad,
                               f"N={n}")
    if not (torch.isfinite(costs_ng).all() and torch.isfinite(grad).all()):
        raise AssertionError(f"main path N={n}: non-finite costs or gradient")
    with torch.no_grad():
        costs_s = wt.rnnt_loss(log_probs, labels, xn, yn, impl="scan")
    cost_err = float((costs_ng - costs_s).abs().max())
    if not (torch.allclose(costs_ng, costs_s, rtol=1e-5, atol=0.0)
            and abs(float(costs_ng.mean()) - float(loss)) <= 1e-5 * abs(float(loss))):
        raise AssertionError(f"main path N={n}: costs differ from the scan"
                             f" ({cost_err}) or the loss from their mean")
    readings = {}
    for s in (0, n // 2, n - 1):
        x = log_probs[s:s + 1].detach().clone().requires_grad_()
        c = wt.rnnt_loss(x, labels[s:s + 1], xn[s:s + 1], yn[s:s + 1])
        c.backward(torch.ones_like(c) / n)
        err = float((grad[s] - x.grad[0]).abs().max())
        scale = float(x.grad.abs().max())
        readings[s] = (err, scale)
        if not err <= 1e-6 * scale:
            raise AssertionError(f"main path N={n}: sample {s}'s gradient"
                                 f" differs from a one-sample call ({err})")
        if s == n - 1:
            xc = log_probs[s:s + 1].detach().cpu().requires_grad_()
            cc = wt.rnnt_loss(xc, labels[s:s + 1].cpu(), xn[s:s + 1].cpu(),
                              yn[s:s + 1].cpu())
            cc.backward(torch.ones_like(cc) / n)
            cpu_err = float((grad[s].cpu() - xc.grad[0]).abs().max())
            if not cpu_err <= 5e-3 * float(xc.grad.abs().max()):
                raise AssertionError(f"main path N={n}: sample {s}'s gradient"
                                     f" differs from the CPU path ({cpu_err})")
            del xc, cc
        del x, c
    print(f"main path N={n} vs scan: costs max abs err {cost_err}; gradient"
          f" of samples 0, n/2, n-1 against one-sample calls (max abs err,"
          f" max |grad|) {readings}; sample {n - 1} against the CPU path max"
          f" abs err {cpu_err}")
    del grad, costs_ng, costs_s

    def step(x):
        x = x.detach().requires_grad_()
        out = wt.rnnt_loss(x, labels, xn, yn, reduction="mean", gather=True)
        out.backward()
        return out.detach(), x.grad

    ms, peak = peak_and_time(torch, timing, step, log_probs, 6)
    R = n * T * U
    b_ms, _ = bound_ms(R * V * 4 + 2 * R * 4, 0, rates)
    print(f"time loss+grad main path N={n}: ms={ms} peak_mem_bytes={peak}"
          f" ({peak / 2**30:.3f} GiB above the inputs) bound_ms={b_ms}"
          f" bound_by=bytes [{card}]")


# ---- slice 5: the two faults, the fused joint at any width and N --------

# Fault 2's widths at the fused slice's lattice (FJ), and the kernels' times
# beside their bounds at the widths past one 512-column slice.
WIDE_H = (200, 640, 1024)
WIDE_TIMED = (640, 1024)
# The entry points at a width past four slices on a smaller lattice, and at
# more samples than a grid's y dimension holds.
WIDE_SMALL = {"H=2048": dict(N=2, T=50, U=11, V=1000, H=2048, F=256),
              "N=65537": dict(N=65537, T=1, U=2, V=64, H=16, F=16)}
FJ_WIDE_PATH = ("fused_joint_hidden", *FJ_PATH)


def neg_inf_inputs(torch, np, headline):
    """Fault 1's input: cell (n=0, t=2, u=1) set to -inf (its blank and its
    label log-prob).  Small: log-softmax of seed-0 normals (numpy's default
    generator), N=2, T=6, U=4, V=7, xn=(6, 5), yn=(3, 2); headline: the main
    path's seeded inputs at N=32, T=150, U=21, V=5000."""
    if headline:
        log_probs, labels, xn, yn = make_inputs(torch, N, T, U, V, SEED)
    else:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 6, 4, 7))
        x = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
        i32 = dict(dtype=torch.int32, device="cuda")
        log_probs = torch.tensor(x, device="cuda")
        labels = torch.tensor(rng.integers(1, 7, (2, 3)), **i32)
        xn, yn = torch.tensor([6, 5], **i32), torch.tensor([3, 2], **i32)
    log_probs[0, 2, 1, :] = -float("inf")
    return log_probs, labels, xn, yn


def phase_neg_inf(torch, np, wt, cuda_impl, costs_and_grads):
    """Fault 1: at the -inf cell, on the small input and at the headline
    shape, the kernels give finite costs and gradients; the lattice kernels
    equal their twin on valid cells (1e-5, as phase 2), the kernel path's
    costs and gathered gradients the twin's (rtol 1e-5; 1e-5 of the largest
    gradient); the loss equals `impl="scan"`'s (costs rtol 1e-5, gradients
    1e-5 of their largest on the small input, `check_main`'s 5e-3 at the
    headline shape).  Returns the largest kernel-against-twin error."""
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext

    worst = 0.0
    for headline in (False, True):
        log_probs, labels, xn, yn = neg_inf_inputs(torch, np, headline)
        n, t, u, v = log_probs.shape
        out = {}
        for impl in ("cuda", "scan"):
            x = log_probs.detach().clone().requires_grad_()
            costs = wt.rnnt_loss(x, labels, xn, yn, impl=impl)
            costs.sum().backward()
            out[impl] = (costs.detach(), x.grad)
        (kc, kg), (sc, sg) = out["cuda"], out["scan"]
        lab = _labels_ext(labels, 0)
        blank = log_probs[..., 0].contiguous()
        emit = torch.gather(log_probs, 3, lab.long()[:, None, :, None].expand(
            n, t, u, 1))[..., 0].contiguous()
        mask = valid_mask(torch, xn, yn, t, u)
        lat_err = 0.0
        for k, p in zip(cuda_impl.alpha_beta(blank, emit, xn, yn),
                        cuda_impl.alpha_beta_plain(blank, emit, xn, yn)):
            k, p = k[mask], p[mask]
            if not (torch.isfinite(k).all()
                    and ((k - p).abs() <= 1e-5 * p.abs() + 1e-5).all()):
                raise AssertionError("fault 1: lattice kernel != twin")
            lat_err = max(lat_err, float((k - p).abs().max()))
        kernel = cuda_impl.forward_backward(blank, emit, xn, yn)[:3]
        twin = costs_and_grads(blank, emit, *cuda_impl.alpha_beta_plain(
            blank, emit, xn, yn), xn, yn, 0.0)
        cost_err = float(((kernel[0] - twin[0]).abs() / twin[0].abs()).max())
        grad_err = max(float((k - p).abs().max()) / float(p.abs().max())
                       for k, p in zip(kernel[1:], twin[1:]))
        scan_cost = float(((kc - sc).abs() / sc.abs()).max())
        scan_grad = float((kg - sg).abs().max()) / float(sg.abs().max())
        tag = "N=32 T=150 U=21 V=5000" if headline else "N=2 T=6 U=4 V=7"
        print(f"fault 1 (-inf cell) {tag}: costs[:2] {kc[:2].tolist()};"
              f" lattice kernel vs twin max abs err {lat_err}; kernel vs twin"
              f" costs rel {cost_err}, grads {grad_err} of the largest;"
              f" vs scan costs rel {scan_cost}, grads {scan_grad} of the"
              " largest")
        finite = all(bool(torch.isfinite(x).all()) for x in (kc, kg, *kernel))
        if not (finite and cost_err <= 1e-5 and grad_err <= 1e-5
                and scan_cost <= 1e-5
                and scan_grad <= (5e-3 if headline else 1e-5)):
            raise AssertionError(f"fault 1 {tag}: non-finite, or off the"
                                 " twin or the scan")
        if not headline and abs(float(kc[0]) - 13.585902) > 1e-5 * 13.585902:
            raise AssertionError("fault 1: sample 0's cost is not 13.585902")
        worst = max(worst, lat_err)
        del log_probs, out, kc, kg, sc, sg
    return worst


def wide_inputs(torch, np, carry, d, seed):
    """Carried params of a Flax-layout tree at d's widths, f, g, labels in
    [1, V) and full lengths on the card (d: N, T, U, V, H, F)."""
    _, params = carry(fj_tree(np, seed, d["F"], d["H"], d["V"]), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn(d["N"], d["T"], d["F"], generator=gen, device="cuda")
    g = torch.randn(d["N"], d["U"], d["F"], generator=gen, device="cuda")
    labels = torch.randint(1, d["V"], (d["N"], d["U"] - 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    i32 = dict(dtype=torch.int32, device="cuda")
    xn = torch.full((d["N"],), d["T"], **i32)
    yn = torch.full((d["N"],), d["U"] - 1, **i32)
    return (f, g, labels, xn, yn), params


def wide_entry_points(torch, wt, fj, cases_mod, counters, jin, params, tag):
    """Loss+grad through `rnnt_loss_fused_joint` and
    `rnnt_loss_joint(layout="fused")`, counts set to 0 just before and read
    just after (the three fused kernels and the alpha+beta sweep; the h
    image kernel when H takes more than one `bwd_plan` slice, then and only
    then), each against the padded layout (loss rtol 2e-3, gradients 2e-2
    of their largest, w_out and b_out per column group).  Returns the
    launches of the first."""
    f, g, labels, xn, yn = jin
    H, V = params["w_out"].shape
    skip = {"lattice_beta_only"}
    if fj.bwd_plan(H)[1] == 1:
        skip.add("fused_joint_hidden")
    want = tuple(k for k in FJ_WIDE_PATH if k not in skip)

    def loss_grad(layout):
        fr, gr = f.detach().requires_grad_(), g.detach().requires_grad_()
        pr = {k: v.detach().requires_grad_() for k, v in params.items()}
        if layout == "entry":
            loss = wt.rnnt_loss_fused_joint(fr, gr, pr, labels, xn, yn,
                                            reduction="mean")
        else:
            loss = wt.rnnt_loss_joint(fr, gr, pr, labels, xn, yn,
                                      reduction="mean", layout=layout)
        loss.backward()
        return loss.detach(), {"f": fr.grad, "g": gr.grad,
                               **{k: v.grad for k, v in pr.items()}}

    ref_loss, ref_grads = loss_grad("padded")
    groups = cases_mod.column_groups(labels, 0, V)
    first = None
    for layout in ("entry", "fused"):
        reset(counters)
        loss, grads = loss_grad(layout)
        torch.cuda.synchronize()
        launches = launched(counters)
        if first is None:
            first = launches
        if [k for k in want if k not in launches] or set(launches) - set(want):
            raise AssertionError(f"fused {tag} {layout}: launched {launches},"
                                 f" its path is {want}")
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        worst = 0.0
        for name, got in grads.items():
            r = cases_mod.check_close(
                f"fused {tag} {layout} vs padded grad {name}", got,
                ref_grads[name], 2e-2,
                groups if name in ("w_out", "b_out") else None)
            worst = max(worst, max(e / s if s else 0.0 for e, s in r.values()))
        print(f"fused joint {tag} via {'rnnt_loss_fused_joint' if layout == 'entry' else 'rnnt_loss_joint(layout=fused)'}:"
              f" launches {launches}; loss {float(loss)} vs padded"
              f" {float(ref_loss)} (rel {rel}); gradients within {worst} of"
              " their largest")
        if rel > 2e-3:
            raise AssertionError(f"fused {tag} {layout}: loss differs")
    return first


def phase_wide_fused(torch, np, wt, fj, cases_mod, carry, counters):
    """Fault 2: (a) the kernels against their plain versions (1e-3 per
    column group, `fused_joint_cases.compare`) on `WIDE_CASES` (H=40, 200,
    640, 1024 with U > 64, 2048, and N=65537) and at the fused slice's
    lattice at H=200, 640 and 1024; the h image kernel against its plain
    version (one bf16 ulp of |h| <= 1, 2^-8); (b) the two entry points
    at those three widths, at H=2048 (N=2, T=50, U=11, V=1000) and at
    N=65537 (T=1, U=2, V=64, H=16), each against the padded layout.
    Returns (errs, launches at H=640, {H: full-width kernel operands})."""
    errs = {}
    for name, case in cases_mod.WIDE_CASES.items():
        ops, cot = cases_mod.kernel_case(*case)
        r = cases_mod.compare(fj, ops, cot, case[6])
        torch.cuda.synchronize()
        print(f"fused joint kernels {name} N,T,U,V,H={case[1:6]}:"
              f" {json.dumps({k: cases_mod.max_err(v) for k, v in r.items()})}")
        del ops, cot
    fulls, launches = {}, None
    for i, H in enumerate(WIDE_H):
        d = dict(FJ, H=H)
        jin, params = wide_inputs(torch, np, carry, d, SEED + 10 + i)
        full = fj_full_case(torch, fj, jin, params)
        ops, cot = full
        r = cases_mod.compare(fj, ops, cot, 0)
        torch.cuda.synchronize()
        errs[H] = {k: cases_mod.max_err(v) for k, v in r.items()}
        print(f"fused joint kernels fused slice H={H}: {json.dumps(r)}")
        if fj.bwd_plan(H)[1] > 1:  # the h image
            a, c, _, _, _, xn, _ = ops
            Hp, S = fj.bwd_plan(H)
            pa, pc, _ = fj.pad_h(a.float(), c.float(), ops[2], Hp)
            pa, pc = pa.contiguous(), pc.contiguous()
            img = fj._hidden_image(pa, pc, xn,
                                   (d["N"], d["T"], d["U"], Hp, d["V"], S))
            want = fj.hidden_image_plain(pa, pc, xn, S)
            err = float((img.float() - want.float()).abs().max())
            errs[H]["fused_joint_hidden"] = err
            print(f"fused_joint_hidden H={H}: max abs err {err}")
            if err > 2.0 ** -8:
                raise AssertionError(f"h image kernel H={H} != plain version")
            del img, want
        got = wide_entry_points(torch, wt, fj, cases_mod, counters, jin,
                                params, f"H={H}")
        if H == 640:
            launches = got
        if H in WIDE_TIMED:
            fulls[H] = full
        del jin, params
    for tag, d in WIDE_SMALL.items():
        jin, params = wide_inputs(torch, np, carry, d, SEED + 20)
        wide_entry_points(torch, wt, fj, cases_mod, counters, jin, params, tag)
        del jin, params
    torch.cuda.empty_cache()
    return errs, launches, fulls


# ---- slice 6: the backward kernels on wgmma --------------------------------

# The fused slice's lattice at the backward's two-slice width.
FJ_H512 = dict(FJ, H=512)
# The joint-layout sweep that decides CUDA "auto", padded and fused in
# turns: JL_SWEEP, and JL (V=5000) and V=64000 (N=2, 20 labels) at each
# joint width of ROUTE_H (640: NeMo's Conformer-Transducer joint).
ROUTE_H = (256, 512, 640, 1024)
ROUTE_SWEEP = (*JL_SWEEP, *(dict(JL, H=h) for h in ROUTE_H),
               *(dict(N=2, T=150, L=20, V=64000, H=h, F=256) for h in ROUTE_H))


def check_deterministic(torch, fj, full_case, tag):
    """Two forward calls on the same operands give bit-equal blank logits,
    label logits and logZ, and two backward calls bit-equal d_a, d_c, d_W
    and d_b (partials summed in a fixed order, no atomics)."""
    (a, c, w, b, lab, xn, yn), (db, de) = full_case
    fwd = [fj.joint_lattice_fwd(a, c, w, b, lab, xn, yn, 0) for _ in range(2)]
    same = [bool(torch.equal(x, y)) for x, y in zip(*fwd)]
    print(f"fused forward {tag}: two calls bit-equal (blank, label, logZ)"
          f" {same}")
    if not all(same):
        raise AssertionError(f"fused forward {tag} is not deterministic")
    logz = fwd[0][2]
    first = fj.joint_lattice_bwd(a, c, w, b, lab, xn, yn, logz, db, de, 0)
    second = fj.joint_lattice_bwd(a, c, w, b, lab, xn, yn, logz, db, de, 0)
    same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
    print(f"fused backward {tag}: two calls bit-equal (d_a, d_c, d_W, d_b)"
          f" {same}")
    if not all(same):
        raise AssertionError(f"fused backward {tag} is not deterministic")


def kernel_attrs(fj):
    """Registers at entry, spills, shared memory and ring stages of the
    forward and each backward kernel, one slice (H=256) and sliced
    (H=512); {kernel: {"H=256": attrs, "H=512": attrs}}."""
    out = {}
    for H in (256, 512):
        for name, attrs in fj.kernel_attrs(H).items():
            print(f"{name} H={H} (bwd_plan {fj.bwd_plan(H)}): {json.dumps(attrs)}")
            out.setdefault(name, {})[f"H={H}"] = attrs
            if attrs["spill_bytes"]:
                print(f"WARNING: {name} spills {attrs['spill_bytes']} bytes"
                      " a thread")
    return out


def time_matmul(torch, timing, rates, card, R=FJ["N"] * FJ["T"] * FJ["U"],
                H=FJ["H"], V=FJ["V"]):
    """One bf16 torch.matmul (R, H) x (H, V), the fused slice's by default:
    the card's attainable rate for one of the fused kernels' products,
    printed as a yardstick (not the same function as any kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    x = torch.randn(R, H, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(H, V, generator=gen, device="cuda").to(torch.bfloat16)
    ms = timing.bench_scalar_chain(torch.matmul, (x, w), 10,
                                   reduce_out=lambda o: o.view(-1)[0].float())
    b_ms, _ = bound_ms(0, 2 * R * H * V, rates, BF16)
    print(f"time matmul bf16 (R,H)x(H,V) R={R} H={H} V={V}: ms={ms}"
          f" bound_ms={b_ms} ({2 * R * H * V / ms / 1e9:.1f} TFLOP/s) [{card}]")
    return ms


def time_route_sweep(torch, np, wt, timing, profile_step, carry, card):
    """`rnnt_loss_joint` loss+grad, padded and fused in turns (padded,
    fused, fused, padded) at each cell of ROUTE_SWEEP, random lengths:
    chained ms, then the device busy ms, the idle share and the kernels a
    call under the profiler, in turns again; the readings
    `functional/joint_loss._CUDA_FUSED_MIN_V` and `_CUDA_FUSED_MAX_H` rest
    on."""
    out = {}
    turns = ("padded", "fused", "fused", "padded")
    for i, dims in enumerate(ROUTE_SWEEP):
        params = carry(fj_tree(np, SEED + 40 + i, dims["F"], dims["H"],
                               dims["V"]), device="cuda")[1]
        f, g, labels, xn, yn = joint_inputs(torch, np, dims, SEED + 50 + i)
        steps = {k: joint_step(wt, k, g, params, labels, xn, yn)
                 for k in ("padded", "fused")}
        reads = {k: {"ms": [], "busy_ms": [], "idle_share": [], "kernels": []}
                 for k in steps}
        for layout in turns:
            reads[layout]["ms"].append(
                peak_and_time(torch, timing, steps[layout], f, 8)[0])
        for layout in turns:
            prof = profile_step(lambda: steps[layout](f))
            reads[layout]["busy_ms"].append(prof["busy_ms"])
            reads[layout]["idle_share"].append(prof["idle_share"])
            reads[layout]["kernels"].append(prof["kernels_per_call"])
        out[f"V={dims['V']} H={dims['H']}"] = reads
        print(f"route sweep V={dims['V']} H={dims['H']} N={dims['N']}"
              f" T={dims['T']} labels={dims['L']} (turns padded, fused, fused,"
              f" padded): {json.dumps(reads)} [{card}]")
        del params, f, g, steps
        torch.cuda.empty_cache()
    return out


# The main path's kernels in a profile of one loss+grad, by symbol, and the
# most other kernels a call may hold (PERF.md names each): the labels' fill
# and cat, the mean, the backward's seed, the mean's backward and the
# cotangent multiply, with two to spare.
MAIN_PROFILE_SYMBOLS = ("column_gather_kernel", "lattice_kernel",
                        "epilogue_kernel", "flat_write_kernel")
MAIN_PROFILE_OTHERS = 8


def hold_main_profile(prof):
    """The headline loss+grad's profile: every `MAIN_PROFILE_SYMBOLS`
    kernel once a call, at most `MAIN_PROFILE_OTHERS` others."""
    names = [key for _, _, key in prof["rows"]]
    counts = {sym: sum(c for _, c, key in prof["rows"] if sym in key)
              for sym in MAIN_PROFILE_SYMBOLS}
    others = prof["kernels_per_call"] - sum(counts.values())
    print(f"profile main path: {json.dumps(counts)} and {others} other"
          f" kernels a call (at most {MAIN_PROFILE_OTHERS})")
    if not prof["complete"] or any(c != 1 for c in counts.values()) or (
            others > MAIN_PROFILE_OTHERS):
        raise AssertionError(f"main path profile: {counts}, {others} others,"
                             f" complete {prof['complete']}: {names}")


def epilogue_attrs(build):
    """ptxas's registers, shared bytes and spills of each output dtype's
    epilogue kernel (`_build.ptxas_report`)."""
    out = {}
    kinds = {"IfE": "fp32", "IdE": "fp64", "__half": "fp16",
             "bfloat16": "bf16"}
    for fn, r in build.ptxas_report("lattice").items():
        if "epilogue_kernel" in fn:
            out[next(v for k, v in kinds.items() if k in fn)] = r
    print(f"epilogue kernel attrs (ptxas): {json.dumps(out)}")
    if any(r.get("spill_stores") or r.get("spill_loads") for r in out.values()):
        print("WARNING: the epilogue kernel spills")
    return out


# The train step (slice 10): the transducer at bench_train.py's shape
# (`train_cases.FULL`: N=32, T=400, U=40, V=1024, 80 features, hidden 512),
# carried from a seeded Flax-layout tree, in each loss mode.
TRAIN_MODES = ("from_logits", "gather", "fused")
TRAIN_STEPS = 5
# The kernels' symbols in the profiler's names, by `LAUNCHES` name.
TRAIN_SYMBOLS = {"lattice_fused": "lattice_kernel",
                 "lattice_epilogue": "epilogue_kernel",
                 "gather_lattice": "column_gather_kernel",
                 "flat_write": "flat_write_kernel",
                 "fused_joint_hidden": "hidden_image_kernel",
                 "fused_joint_fwd": "fwd_kernel",
                 "fused_joint_bwd_dadc": "dadc_kernel",
                 "fused_joint_bwd_dwdb": "dwdb_kernel"}


def train_bounds(rates, R):
    """Each train-path kernel's bound a step at `train_cases.FULL`, with R
    valid cells, by the conventions of the kernels' own timings: the
    lattice, the gather (a sector a gathered value) and the write (the dense
    gradient) by bytes over every cell; the fused kernels by their bf16
    products on the valid cells (forward one R x H x V product, each
    backward kernel two); the h image by its bytes, twice a step."""
    from warp_rnnt_tpu_torch.benchmarks import h_image as hi
    from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

    n, t, u, v, h = (tc.FULL[k] for k in "NTUVH")
    cells = n * t * u
    prod = 2 * R * h * v
    work = {"lattice_fused": (*lattice_work(n, t, u, True), 1),
            "lattice_epilogue": (epilogue_bytes(n, t, u, 4), 0, 1),
            "gather_lattice": (2 * cells * (32 + 4), 0, 1),
            "flat_write": (cells * v * 4 + 2 * cells * 4 + n * u * 4, 0, 1),
            "fused_joint_fwd": (0, prod, BF16),
            "fused_joint_bwd_dadc": (0, 2 * prod, BF16),
            "fused_joint_bwd_dwdb": (0, 2 * prod, BF16),
            "fused_joint_hidden": (2 * hi.bound_bytes(n, t, u, h), 0, 1)}
    return {k: bound_ms(b, o, rates, r) for k, (b, o, r) in work.items()}


def phase_train(torch, card, rates):
    """Step-0 loss and gradients in each mode with the counts set to 0 just
    before and read just after (exactly the mode's kernels), "gather" and
    "fused" against "from_logits"; the lattice sweep each mode's step 0 ran
    against the plain version in float64 on the same inputs
    (`train_cases.lattice_matches_plain`); TRAIN_STEPS AdamW steps a mode
    with the loss falling; one small step on the card against the CPU a
    mode; then `bench_train` a mode, compiled and eager in one call, with
    each kernel's device ms a step under the profiler (of the compiled
    step's replays) beside its bound (`train_bounds`).  Returns (launches
    a step by mode, device ms a step by mode and kernel, (bound ms, bound
    by) by kernel, the largest error over its allowance by check, the
    lattice's largest error on valid cells by mode, bench_train's eager
    chained step ms by mode, the port's kernels a compiled replay by
    mode)."""
    from warp_rnnt_tpu_torch.benchmarks import bench_train
    from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
    from warp_rnnt_tpu_torch.models import make_train_step

    model, batch = tc.carried(SEED + 41, tc.FULL)
    out, launches, errs = {}, {}, {}
    lattice_errs = {}
    for mode in TRAIN_MODES:
        with tc.recorded_lattice() as sweeps:
            loss, grads, launches[mode] = tc.launches_per_step(model, batch,
                                                               mode)
        out[mode] = loss, grads
        print(f"train step {mode} at {json.dumps(tc.FULL)}: loss"
              f" {float(loss):.6f}, launches a step {launches[mode]}")
        (sweep,) = sweeps
        lattice_errs[mode] = tc.lattice_matches_plain(
            sweep, f"train {mode} lattice")
        print(f"train step {mode}: lattice_fused on its {tuple(sweep[0].shape)}"
              f" lattice against the float64 plain version: max abs err on"
              f" valid cells {lattice_errs[mode]}, costs and gradients within"
              f" rtol {tc.COST_RTOL} and {tc.LATTICE_GRAD_TOL} of the largest")
        del sweeps, sweep
    for mode in TRAIN_MODES[1:]:
        errs[mode] = tc.compare_grads(out["from_logits"], out[mode],
                                      f"train {mode} vs from_logits")
        print(f"train step {mode} vs from_logits: loss"
              f" {float(out[mode][0]):.6f} / {float(out['from_logits'][0]):.6f},"
              f" gradients at {errs[mode]:.3f} of their allowance")
    del out, model
    for mode in TRAIN_MODES:
        model, batch = tc.carried(SEED + 41, tc.FULL)
        opt = torch.optim.AdamW(model.parameters(), lr=tc.LR,
                                weight_decay=tc.WEIGHT_DECAY)
        step = make_train_step(model, opt, loss_mode=mode)
        losses = [float(step(batch)) for _ in range(TRAIN_STEPS)]
        print(f"train {mode}: {TRAIN_STEPS} AdamW steps, losses {losses}")
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"train {mode}: the loss did not fall {losses}")
    del model, opt, step
    for mode in TRAIN_MODES:
        worst, (moved, share), small = tc.card_matches_cpu(mode)
        errs[f"{mode} card vs cpu"] = worst
        errs[f"{mode} card vs cpu step"] = moved / tc.STEP_ATOL
        print(f"train step {mode} at {json.dumps(tc.SMALL)}, card against"
              f" CPU: gradients at {worst:.3f} of their allowance; after one"
              f" AdamW step, parameters within {moved:.2e} (allowance"
              f" {tc.STEP_ATOL:.0e}) on the {share:.3f} of entries whose"
              f" gradients agree in sign above {tc.STEP_GRAD_MIN:.0e};"
              f" launches {small}")
    torch.cuda.empty_cache()
    device_ms, step_ms, replay = {}, {}, {}
    for mode in TRAIN_MODES:
        r = bench_train.bench_train(loss_mode=mode)  # compiled and eager
        e = r["eager"]
        step_ms[mode] = e["step_ms"]
        rows = r.pop("kernels")
        e_rows = e.pop("kernels")
        replay[mode] = ours({name: count for _, count, name in rows})
        for tag, x in (("eager", e), ("compiled", r)):
            print(f"time train step {mode} {tag}: {x['step_ms']:.3f} ms"
                  f" chained ({x['utts_per_s']:.1f} utts/s), bound"
                  f" {r['bound_ms']:.3f} ms ({r['bound_by']}),"
                  f" {x['kernels_per_step']} kernels a step, busy"
                  f" {x['busy_ms']:.3f} ms, idle {x['idle_share']:.3f}, peak"
                  f" {x['peak_mb']:.1f} MB, {r['params_m']} M params [{card}]")
        print(f"time train step {mode} compiled: capture {r['capture_ms']:.1f}"
              f" ms, pool {r['pool_mib']:.1f} MiB, the port's kernels a"
              f" replay {json.dumps(replay[mode])} [{card}]")
        counts = {tag: {} for tag in ("eager", "compiled")}
        for tag, kernel_rows in (("eager", e_rows), ("compiled", rows)):
            for _, count, name in kernel_rows:
                counts[tag][name] = counts[tag].get(name, 0) + count
        moved = {name[:60]: counts["compiled"].get(name, 0)
                 - counts["eager"].get(name, 0)
                 for name in {*counts["eager"], *counts["compiled"]}
                 if counts["compiled"].get(name, 0)
                 != counts["eager"].get(name, 0)}
        print(f"train {mode}: launches a compiled replay minus an eager step,"
              f" by kernel: {json.dumps(moved)}")
        print(f"bench_train {json.dumps(r)}")
        for tag, kernel_rows in (("eager", e_rows), ("compiled", rows)):
            for ms, count, name in kernel_rows[:bench_train.TOP]:
                print(f"profile train {mode} {tag} {ms:.4f} ms/step {count}"
                      f" x/step {name}")
        device_ms[mode] = {k: sum(ms for ms, _, name in rows
                                  if f"::{sym}" in name)
                           for k, sym in TRAIN_SYMBOLS.items()}
        torch.cuda.empty_cache()
    bounds = train_bounds(rates, r["valid_cells"])  # one batch for every mode
    for k, (b_ms, b_by) in bounds.items():
        print(f"time train kernel {k}: device ms a step"
              f" {json.dumps({m: device_ms[m][k] for m in TRAIN_MODES})},"
              f" bound {b_ms:.4f} ms ({b_by}) [{card}]")
    return launches, device_ms, bounds, errs, lattice_errs, step_ms, replay


SERVING_KERNELS = ("gather_lattice", "lattice_fused", "lattice_beta_only",
                   "lattice_epilogue", "flat_write")
# The decode step's kernels (slice 17): the XLA while bodies they stand in
# for, and their launches in one graphed step at most.
STEP_SOURCE = "warp_rnnt_tpu_torch/csrc/decode_step.cu"
STEP_REPLACES = ("warp_rnnt_tpu/models/decoding.py:119 and"
                 " warp_rnnt_tpu/models/beam_search.py:298 (the XLA while"
                 " body; no TPU kernel)")
SELECT_REPLACES = ("warp_rnnt_tpu/models/beam_search.py:207-294 (the XLA"
                   " while body's selection, gathers, hash and merge; no TPU"
                   " kernel)")
# The kernels of a graphed step, and their launches a step at most.
STEP_OF = {"greedy": ("decode_joint", "decode_gru"),
           "beam": ("decode_joint", "decode_beam_select", "decode_gru")}
STEP_LAUNCHES = {"greedy": 4, "beam": 5}


def decode_step_checks(torch, dsc, model, feats, xn, d, cd):
    """The decode step's kernels against their plain versions on the
    states a plain greedy and a plain beam decode visit at ``d``'s width
    (`decode_step_cases.check_records`, `check_select_records`: the
    selection bit for bit), whole decodes' tokens, the kernels' against
    the plain step's (reported), and a beam decode and a streaming beam
    session (chunks of 16) on the kernels against the parent's path
    (`check_parent_path`: the selection plain, the joint and the GRU on
    their kernels), bit for bit.  Returns (the recorders, the joint's
    and GRU's results, the selection's)."""
    recs, outs = dsc.record_states(model, feats, xn, d["max_length"],
                                   d["beam"])
    r = dsc.check_records(recs)
    sel = dsc.check_select_records(recs)
    parent = dsc.check_parent_path(model, feats, xn, d["max_length"],
                                   d["beam"], 16)
    print(f"decode_beam_select at {json.dumps(d)}, {cd}: equal to the plain"
          f" version bit for bit on every recorded state: {json.dumps(sel)};"
          f" a beam decode and a streaming beam session (C=16) on the"
          f" kernels equal the parent's path (the selection plain, the"
          f" joint and the GRU on their kernels) bit for bit in tokens,"
          f" lengths and scores: lengths {json.dumps(parent['decode'])}")
    agree = dsc.token_agreement(model, feats, xn, d["max_length"], d["beam"],
                                outs)
    fold = dsc.check_fold_records(recs)
    print(f"decode step kernels folded at {json.dumps(d)}, {cd}: every"
          f" recorded greedy GRU and beam selection call with the loop's"
          f" mask and count folded in, cond true and false, against its"
          f" folded plain version (integers, last_tok, count, selection bit"
          f" for bit; the state within {dsc.GRU_TOL} and equal to the"
          f" unfolded kernel's): {json.dumps(fold)}")
    print(f"decode step kernels at {json.dumps(d)}, {cd}: against the plain"
          f" step on the states a plain decode visits (logp within"
          f" {dsc.FP32_TOL} + {dsc.BF16_ULPS} bf16 ulps of the row's largest"
          f" logit in bf16, ids equal where the plain margin exceeds twice"
          f" that, the GRU's state within {dsc.GRU_TOL}, non-emitting rows"
          f" bit for bit): {json.dumps(r)}; whole decodes on the kernels"
          f" against the plain step (reported, not held): {json.dumps(agree)}")
    return recs, r, sel, fold


def decode_step_times(torch, bd, dsc, model, recs, d, card):
    """Each step kernel's device ms beside its plain version's and its
    bound, on states of the bf16 plain decodes: greedy (N rows) and beam
    (N x beam rows); the joint's and beam's selection's from the middle
    of the decode, the GRU's where the most rows emit (after the <sos>
    step); then that beam GRU call without a row map, with the identity
    and with its parents' (`gru_row_map_times`, printed).  Returns
    {decoder: {kernel: {ms, plain_ms, bound_ms, bound_by, rows,
    emitting}}}."""
    out = {}
    for dec, gru in (("greedy", "decode_gru_greedy"), ("beam", "decode_gru")):
        calls = recs[dec].calls
        joint = calls["decode_joint"][len(calls["decode_joint"]) // 2]
        step = max(calls[gru][1:] or calls[gru],
                   key=lambda a: int(dsc.emit_mask(gru, a).sum()))
        selects = calls["decode_beam_select"]
        times = dsc.kernel_times(
            joint, gru, step,
            call_select=selects[len(selects) // 2] if selects else None)
        rows = joint[3].shape[0]
        emitting = int(dsc.emit_mask(gru, step).sum())
        k = joint[10] if len(joint) > 10 else None
        bounds = bd.kernel_bounds(model, d["N"], rows, k, d["max_length"],
                                  emitting)
        out[dec] = {"yardsticks": times.pop("yardsticks")}
        for kernel, t in times.items():
            us, by = bounds[kernel]
            out[dec][kernel] = {**t, "bound_ms": us / 1e3, "bound_by": by,
                                "rows": rows, "emitting": emitting}
            turns = (f"; the first kernels (`decode_step_baseline.cu`) in"
                     f" turns, baseline / this / this / baseline: flushed"
                     f" {t['baseline_ms'][0]:.6f} / {t['turns_ms'][0]:.6f} /"
                     f" {t['turns_ms'][1]:.6f} / {t['baseline_ms'][1]:.6f},"
                     f" warm {t['baseline_warm_ms'][0]:.6f} /"
                     f" {t['turns_warm_ms'][0]:.6f} /"
                     f" {t['turns_warm_ms'][1]:.6f} /"
                     f" {t['baseline_warm_ms'][1]:.6f}"
                     if "turns_ms" in t else "")
            print(f"time decode step {kernel} {dec} ({rows} rows,"
                  f" {emitting} emitting): {t['ms']:.6f} ms on the device,"
                  f" L2 flushed; {t['warm_ms']:.6f} with L2 warm (plain"
                  f" {t['plain_ms']:.6f}), bound {us / 1e3:.6f} ms ({by})"
                  f"{turns} [{card}]")
        print(f"time decode step yardsticks {dec} ({rows} rows; one PyTorch"
              f" call a layer, never called by the port; flushed / warm"
              f" ms): {json.dumps(out[dec]['yardsticks'])} [{card}]")
    ways = dsc.gru_row_map_times(step)  # the last decoder's: beam's
    print(f"time decode step decode_gru beam ({rows} rows, {emitting}"
          f" emitting) by its row map, in turns (none, identity, recorded,"
          f" recorded, identity, none): {json.dumps(ways)} ms [{card}]")
    return out


def decode_redesign_checks(torch, dsc, recs, seed):
    """The dense and GRU kernels at a wide model's widths and at widths
    that take a ring (`decode_step_cases.wide_cases`, the tolerances as
    at bench width), two calls of each bit for bit (`check_deterministic`,
    WIDE and RING), and a captured greedy step's programmatic edges
    (`pdl_edges`: at least one where the library was built with them).
    Returns {"wide", "ring": max_abs_err by kernel, "plans",
    "deterministic_calls", "pdl": (programmatic, edges)}."""
    from warp_rnnt_tpu_torch.ops import decode_step as ds

    wide = dsc.wide_cases(seed)
    errs = {}
    for name in ("wide", "ring"):
        cases = {k: v for k, v in wide[name].items() if k != "plans"}
        errs[name] = {kernel: max((c[kernel]["max_abs_err"]
                                   for c in cases.values() if kernel in c),
                                  default=0.0)
                      for kernel in ("decode_joint", "decode_gru",
                                     "decode_gru_greedy")}
        print(f"decode step kernels at {name} widths"
              f" {json.dumps(dsc.WIDE if name == 'wide' else dsc.RING)},"
              f" (rows, samples, k)"
              f" {dsc.WIDE_ROWS if name == 'wide' else dsc.RING_ROWS}, add"
              f" and concat, fp32 and bf16, against the plain versions"
              f" (the same tolerances): {json.dumps(cases)}; plans"
              f" {json.dumps(wide[name]['plans'])}")
    calls = (dsc.check_deterministic(seed)
             + dsc.check_deterministic(seed, dims=dsc.RING,
                                       rows_list=dsc.RING_ROWS))
    g = recs["greedy"].calls
    programmatic, edges = dsc.pdl_edges(g["decode_joint"][len(g["decode_joint"]) // 2],
                                        g["decode_gru_greedy"][-1])
    if ds.pdl_built() and programmatic < 1:
        raise AssertionError(f"a captured step has no programmatic edge"
                             f" ({edges} edges)")
    steps = dsc.step_edges(recs)
    if ds.pdl_built() and not all(r["gru_to_hidden"] for r in steps.values()):
        raise AssertionError(f"a folded step's GRU to the next step's hidden"
                             f" layer is not a programmatic edge: {steps}")
    print(f"decode step folded, captured steps' (programmatic, all) edges,"
          f" one step and two: {json.dumps(steps)} (gru_to_hidden: the edge"
          f" from a step's GRU to the next step's hidden layer is"
          f" programmatic)")
    print(f"decode step kernels: {calls} calls twice on the same arguments"
          f" (wide and ring widths), equal bit for bit; a captured greedy"
          f" step (decode_joint, decode_gru_greedy): {programmatic}"
          f" programmatic edges of {edges} (built with programmatic"
          f" dependent launch: {ds.pdl_built()})")
    return {**errs, "deterministic_calls": calls, "pdl": (programmatic, edges),
            "step_edges": steps,
            "fold": {name: max((e["max_abs_err"] for c in wide[name].values()
                                for k, e in c.items() if "folded" in k),
                               default=0.0) for name in ("wide", "ring")},
            "plans": {k: wide[k]["plans"] for k in ("wide", "ring")}}


def decode_step_in_turns(dsc, model, feats, xn, d, card):
    """The graphed greedy and beam step's device us and each step kernel's
    us in it (a replay's profile) on the first kernels and on these, in
    turns (`decode_step_cases.step_times`); then these kernels under the
    loop's own mask (`UNFOLDED`) and folded, in turns; one `time` line
    each."""
    from warp_rnnt_tpu_torch.ops import decode_step as ds

    fold = dsc.step_times(model, feats, xn, d["max_length"], d["beam"],
                          (("unfolded", dsc.UNFOLDED), ("folded", ds)))
    for name, r in fold.items():
        runs = [r[w][i] for w, i in (("unfolded", 0), ("folded", 0),
                                     ("folded", 1), ("unfolded", 1))]

        def turns(key):
            return " / ".join(f"{x[key]:.3f}" for x in runs)

        print(f"time decode step graphed {name} (unroll 16) in turns, the"
              f" loop's own mask / folded / folded / the loop's own mask:"
              f" {turns('step_us')} us a step, kernels a step"
              f" {turns('kernels_a_step')}, a drain of the encoder's frames"
              f" {turns('drain_ms')} ms; kernels' us a step under the"
              f" profiler: folded"
              f" {json.dumps(r['folded'][0]['kernel_us'])}, unfolded"
              f" {json.dumps(r['unfolded'][0]['kernel_us'])} [{card}]")
    out = dsc.step_times(model, feats, xn, d["max_length"], d["beam"])
    for name, r in out.items():
        ours = [x["step_us"] for x in r["kernels"]]
        base = [x["step_us"] for x in r["baseline"]]
        ms = [r[w][i]["drain_ms"] for w, i in (("baseline", 0), ("kernels", 0),
                                                  ("kernels", 1), ("baseline", 1))]
        print(f"time decode step graphed {name} (unroll 16) in turns,"
              f" first kernels / these / these / first kernels:"
              f" {base[0]:.3f} / {ours[0]:.3f} / {ours[1]:.3f} /"
              f" {base[1]:.3f} us a step, a drain of the encoder's frames"
              f" {ms[0]:.3f} / {ms[1]:.3f} / {ms[2]:.3f} / {ms[3]:.3f} ms;"
              f" kernels' us a step under the"
              f" profiler: these {json.dumps(r['kernels'][0]['kernel_us'])},"
              f" first {json.dumps(r['baseline'][0]['kernel_us'])} [{card}]")
    return {**out, "fold": fold}


def ptxas_of(report, kernel):
    """{readable name: ptxas's registers, shared bytes, spills} of the
    entry functions of ``report`` (`_build.ptxas_report`) named for
    ``kernel``."""
    import re

    out = {}
    for name, r in report.items():
        m = re.search(r"\d(decode_\w+?_kernel)(?:I(13__nv_bfloat16|f)Lb([01])E)?",
                      name)
        if m is None or not m.group(1).startswith(kernel):
            continue
        label = m.group(1)
        if m.group(2):
            label += (f"<{'bf16' if m.group(2) != 'f' else 'fp32'},"
                      f" {'true' if m.group(3) == '1' else 'false'}>")
        out[label] = r
    return out


def hold_step_kernels(r, name, card, replaced):
    """A graphed step launches the step's kernels (`STEP_OF`), at most
    `STEP_LAUNCHES` between them, beam's selection and GRU once each, and
    none of the library kernels they replaced (``replaced``, by name;
    `bench_decode.step_kernels`, from a graph replay's profile); with the
    loop's mask folded into the step's kernels, a replay launches no
    ``where`` kernel and fewer kernels outside the step's than it takes
    steps (`bench_decode.round_kernels`: only the round's tail)."""
    ours = r[f"{name}_graph_step_kernels"]
    left = r[f"{name}_graph_step_replaced"]
    tail = r[f"{name}_graph_round_kernels"]
    wheres = {k: n for k, n in tail.items() if "where" in k.lower()}
    if wheres or sum(tail.values()) >= r["unroll"]:
        raise AssertionError(f"{name}: a replay of {r['unroll']} steps"
                             f" launches {sum(tail.values())} kernels outside"
                             f" the step's ({tail}); where kernels {wheres}")
    total = sum(ours.values())
    for kernel in STEP_OF[name]:
        if not any(kernel in key for key in ours):
            raise AssertionError(f"{name}: no {kernel} kernel in a graphed"
                                 f" step: {ours}")
    once = {k: sum(n for key, n in ours.items() if k in key)
            for k in ("decode_beam_select", "decode_gru")}
    if name == "beam" and any(n != 1 for n in once.values()):
        raise AssertionError(f"beam: launches a step {once}, not one each")
    if total > STEP_LAUNCHES[name] or left:
        raise AssertionError(f"{name}: {total} step kernels a step"
                             f" ({ours}), replaced kernels left: {left}")
    print(f"profile graphed {name} step: {json.dumps(ours)} ({total} launches"
          f" a step, at most {STEP_LAUNCHES[name]}); no {', '.join(replaced)}"
          f" kernel left; {r[f'{name}_graph_kernels_per_step']} kernels and"
          f" {r[f'{name}_graph_step_us']} us a step; outside the step's, a"
          f" replay of {r['unroll']} steps launches {sum(tail.values())}"
          f" kernels, none a where: {json.dumps(tail)} [{card}]")
    return total



LOOP_SOURCE = "warp_rnnt_tpu_torch/csrc/device_loop.cu"
LOOP_REPLACES = ("warp_rnnt_tpu/models/decoding.py:119 and"
                 " warp_rnnt_tpu/models/beam_search.py:298 (XLA's"
                 " lax.while_loop on the device; no TPU kernel)")


def device_loop_checks(torch, model, feats, xn, d, card):
    """The device loop's while node (slice 25,
    `benchmarks/device_loop_cases.py`): toy loops, cond false at entry and
    a loop past its bound against the eager loop; `loop_continue_kernel`
    against the eager loop's stop rule; greedy, beam and streaming
    sessions at bench width against the plain loop with one host read a
    drain; the bodies' node kinds and edges; the drains' launch ms at
    unroll 1, 4, 16; the node's ms a round.  Returns the kernels line's
    entry for `loop_continue_kernel` (its launches set by the caller)."""
    from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc
    from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
    from warp_rnnt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    toys = {f"{case} unroll {u}": dlc.check_toy(case, u)
            for case in sorted(dlc.LIMITS) for u in dlc.UNROLLS}
    entry = dlc.check_false_at_entry()
    bound = dlc.check_bound()
    print(f"device loop toys ({', '.join(sorted(dlc.LIMITS))}; unroll"
          f" {dlc.UNROLLS}): one while launch each equals the eager loop"
          f" bit for bit with JAX's trip count and one host read;"
          f" {json.dumps(toys)}; cond false at entry {json.dumps(entry)};"
          f" past its bound, after one launch: {json.dumps(bound)}")
    cont = dlc.check_continue()
    print(f"loop_continue_kernel against the eager loop's stop rule:"
          f" {cont['cases']} cases (unroll {dlc.UNROLLS}, trips"
          f" {dlc.PROBE_TRIPS}, bounds {dlc.PROBE_BOUNDS}), steps, count and"
          f" cond equal; {json.dumps(cont)}")
    drains = dlc.check_drains(model, feats, xn, d["max_length"], d["beam"],
                              16)
    print(f"serving while node at {json.dumps(d)}, bf16, unroll 16: greedy,"
          f" beam {d['beam']} and sessions of C=16 equal the plain loop bit"
          f" for bit on the whole state, the same trip counts, host reads a"
          f" drain 1: {json.dumps(drains)}")
    greedy_decode(model, feats, xn, d["max_length"])
    beam_decode(model, feats, xn, d["max_length"], beam_size=d["beam"])
    bodies = {name: dlc.body_report(name) for name in ("greedy", "beam")}
    print(f"serving while node bodies (node kinds; (programmatic, all)"
          f" edges of the round as built and as captured):"
          f" {json.dumps(bodies)}")
    unrolls = dlc.unroll_times(model, feats, xn, d["max_length"], d["beam"])
    for name, r in unrolls.items():
        print(f"time device loop {name} drain, the while launch alone (and"
              f" its rounds as host-launched replays, no read between), by"
              f" unroll: " + ", ".join(
                  f"{u}: {min(v['launch_ms']):.3f}-{max(v['launch_ms']):.3f}"
                  f" ms ({min(v['replays_ms']):.3f}-"
                  f"{max(v['replays_ms']):.3f}; {v['rounds']} rounds,"
                  f" {v['iterations']} iterations, {v['host_reads']} read)"
                  for u, v in r.items()) + f" [{card}]")
    times = dlc.continue_times()
    print(f"time device loop round (probe, unroll 1): while node"
          f" {times['ms'] * 1e3:.3f} us a round, plain loop (a host read a"
          f" round) {times['plain_ms'] * 1e3:.3f} us; bound"
          f" {times['bound_ms']:.3e} ms ({times['bound_by']});"
          f" {json.dumps(times['runs'])} [{card}]")
    print(f"phase device loop: {time.perf_counter() - t0:.1f} s")
    return {"name": "loop_continue_kernel", "route": "cuda",
            "source": LOOP_SOURCE, "replaces": LOOP_REPLACES,
            "launches": None, "max_abs_err": cont["max_abs_err"],
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": None, "check_cases": cont["cases"],
            "host_reads_a_drain": {k: v["host_reads"] / v["drains"]
                                   for k, v in drains.items()},
            "drain_launch_ms_by_unroll": {
                name: {u: v["launch_ms"] for u, v in r.items()}
                for name, r in unrolls.items()},
            "drain_replays_ms_by_unroll": {
                name: {u: v["replays_ms"] for u, v in r.items()}
                for name, r in unrolls.items()},
            "body": bodies, "ptxas": _build.ptxas_report("device_loop")}


def phase_serving(torch, wt, timing, card):
    """The serving path (`benchmarks/serving_cases.py`): the restricted
    loss and the alignment at the main path's shape, the decoders at
    bench_decode.py's width, streaming at bench_streaming.py's; each
    check raises on a failure.  Returns ({call: {kernel: launches}} with
    the counts set to 0 just before each call and read just after, the
    restricted loss's errors)."""
    from warp_rnnt_tpu_torch.benchmarks import bench_decode as bd
    from warp_rnnt_tpu_torch.benchmarks import bench_streaming as bs
    from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
    from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
    from warp_rnnt_tpu_torch.models import beam_decode, greedy_decode
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
    from warp_rnnt_tpu_torch.ops import _build
    from warp_rnnt_tpu_torch.ops import decode_step as ds
    from warp_rnnt_tpu_torch.utils import device_loop as dl

    inputs = sc.restricted_inputs(SEED + 51, **sc.RESTRICTED)
    lp, labels, xn, yn, frames = inputs
    shape = json.dumps(sc.RESTRICTED)
    errs, grad_launches, no_grad_launches = sc.check_restricted(*inputs)
    launches = {"restricted": grad_launches,
                "restricted_no_grad": no_grad_launches}
    print(f"serving restricted loss at {shape}, left {sc.LEFT} right"
          f" {sc.RIGHT}: against the scan {json.dumps(errs)} (costs rtol"
          f" {sc.COST_RTOL}, gradients {sc.GRAD_TOL} of the largest); a"
          f" huge band equals rnnt_loss bit for bit; samples {sc.INFEASIBLE}"
          f" infeasible: raw kernel cost {errs['infeasible_raw_cost']:.6e}"
          f" -> +inf, gradients exactly 0 and finite, left out of sum and"
          f" mean; launches {json.dumps(launches)}")
    costs = wt.rnnt_loss(lp, labels, xn, yn)
    (scores, _, a_err), launches["alignment"] = sc.launched(
        lambda: sc.check_alignment(lp, labels, xn, yn, costs))
    print(f"serving alignment at {shape}: frames equal the CPU's, scores"
          f" rtol {a_err:.3e}; Viterbi score <= -cost in every sample (gap"
          f" {float((-costs - scores).min()):.4f} to"
          f" {float((-costs - scores).max()):.4f})")

    def loss_grad(fn):
        def step(x):
            x = x.detach().requires_grad_()
            loss = fn(x)
            loss.backward()
            return loss.detach(), x.grad
        return step

    restricted = lambda x: wt.rnnt_loss_restricted(  # noqa: E731
        x, labels, xn, yn, frames, sc.LEFT, sc.RIGHT, reduction="mean")
    plain = lambda x: wt.rnnt_loss(x, labels, xn, yn,  # noqa: E731
                                   reduction="mean", gather=True)
    times = {}
    for name, fn in (("restricted", restricted), ("rnnt_loss", plain)):
        times[f"{name} loss+grad"] = timing.bench_grad_chain(
            loss_grad(fn), lp, 20)
        with torch.no_grad():
            times[f"{name} no-grad"] = timing.bench_scalar_chain(
                fn, (lp,), 20)
        prof = profile_step(lambda: loss_grad(fn)(lp))
        times[f"{name} kernels a loss+grad"] = prof["kernels_per_call"]
        times[f"{name} busy ms"] = prof["busy_ms"]
    times["alignment"] = timing.bench_scalar_chain(
        wt.rnnt_alignment, (lp, labels, xn, yn), 4,
        reduce_out=lambda out: out[0].sum())
    for k, v in times.items():
        print(f"time serving {k} at {shape}: {v} [{card}]")
    del inputs, lp, costs, scores
    torch.cuda.empty_cache()

    d = sc.DECODE
    feats = sc.features(SEED + 62, d["N"], d["T"], d["F"])
    xn = torch.full((d["N"],), d["T"], dtype=torch.int32, device="cuda")
    step_checks, select_checks, fold_checks = {}, {}, {}
    for cd in (torch.float32, torch.bfloat16):  # bf16: the default model
        model = sc.carried_model(d, SEED + 61, compute_dtype=cd)
        g_len, beam_out = sc.check_decoders(model, feats, xn, d["V"],
                                            d["beam"], d["max_length"])
        fp32 = cd == torch.float32
        gaps = sc.beam_score_gaps(model, feats, xn, beam_out,
                                  sc.SCORE_ATOL if fp32 else None)
        print(f"serving decoders at {json.dumps(d)}, {cd}: beam 1 equals"
              f" greedy; beam tokens in [1, V); greedy lengths"
              f" {g_len.tolist()}, beam {beam_out[1].tolist()}; beam score"
              f" minus its tokens' Viterbi score on the full lattice"
              f" {gaps[1]:.6f} to {gaps[0]:.6f}"
              + (f" (at most {sc.SCORE_ATOL} + the sums' fp32 rounding:"
                 f" {gaps[2]:.3f} of it)" if fp32 else
                 " (not held: bf16 rounds by row count)"))
        loops = sc.check_graphed(model, feats, xn, d["max_length"], d["beam"])
        print(f"serving graphed decoders at {json.dumps(d)}, {cd}, unroll"
              f" {dl.UNROLL}: greedy and beam {d['beam']} equal the plain"
              f" loop bit for bit (tokens, lengths, scores), the same trip"
              f" counts, one host read a drain; {json.dumps(loops)}")
        recs, step_checks[str(cd)], select_checks[str(cd)], fold = (
            decode_step_checks(torch, dsc, model, feats, xn, d, cd))
        fold_checks[str(cd)] = fold
    odd = dsc.odd_cases(SEED + 63)
    print(f"decode step kernels at odd widths {json.dumps(dsc.ODD)}, (rows,"
          f" samples, k) {dsc.ODD_ROWS}, add and concat, fp32 and bf16:"
          f" {json.dumps(odd)}")
    select_odd = dsc.select_cases(SEED + 64)
    kinds = ", ".join(dsc.SELECT_SAMPLES)
    print(f"decode_beam_select on hand-built states ({kinds} samples;"
          f" L={dsc.ODD['L']}, V={dsc.ODD['V']}, beams"
          f" {dsc.SELECT_BEAMS}): equal to the plain version bit for bit;"
          f" {json.dumps(select_odd)}")
    select_fold = dsc.select_fold_cases(SEED + 66)
    print(f"decode_beam_select folded on the same hand-built states, the"
          f" loop's cond true and false: equal to the folded plain version"
          f" bit for bit (the count too); {json.dumps(select_fold)}")
    fold_drains = dsc.check_fold(model, feats, xn, d["max_length"], d["beam"],
                                 16)
    print(f"serving folded drains at {json.dumps(d)}, bf16, unroll"
          f" {dl.UNROLL}: greedy, beam {d['beam']} and their streaming"
          f" sessions (C=16) through the graphs, the loop's mask and count"
          f" in the step's kernels, equal the unfolded drains on the same"
          f" kernels (the loop's own mask), eager and graphed, bit for bit"
          f" on the whole state with the same trip counts:"
          f" {json.dumps(fold_drains)}")
    loop_entry = device_loop_checks(torch, model, feats, xn, d, card)
    step_times = decode_step_times(torch, bd, dsc, model, recs, d, card)
    redesign = decode_redesign_checks(torch, dsc, recs, SEED + 65)
    in_turns = decode_step_in_turns(dsc, model, feats, xn, d, card)
    del recs
    captures = sc.check_graph_cache(model, feats, xn, d["max_length"])
    print(f"serving graph cache: a second greedy decode of one shape"
          f" captured {captures[0]} graphs, one of a length padding to the"
          f" same width {captures[1]}, one with TF32 flipped {captures[2]};"
          f" {len(dl.entries())} graphs cached, their pools"
          f" {dl.pool_mb():.1f} MiB")
    gap = sc.check_card_equals_cpu(SEED)
    print(f"serving small fp32 model {json.dumps(sc.SMALL)}: card tokens equal"
          f" the CPU's, greedy and beam; beam scores within {gap:.3e}")
    # the decoders' main path: greedy and beam decodes from an empty graph
    # cache, the counts set to 0 just before (a graph's replays launch
    # without Python: the counts hold the warm-up round and the capture)
    dl.clear()
    _, step_launches = sc.launched(lambda: (
        greedy_decode(model, feats, xn, d["max_length"]),
        beam_decode(model, feats, xn, d["max_length"], beam_size=d["beam"])))
    if not all(step_launches.get(k) for k in (*STEP_OF["beam"],
                                                 "loop_continue_kernel")):
        raise AssertionError(f"decoders launched {step_launches}")
    print(f"serving decoders' main path at {json.dumps(d)}: launches"
          f" {json.dumps(step_launches)} (the step's: warm-up and capture"
          f" rounds; loop_continue_kernel: while launches, one a decode)")
    decode = {}
    for loop in ("plain", "graphed"):
        r = decode[loop] = bd.bench_decode(
            d["N"], d["T"], d["V"], d["beam"], d["F"], d["H"],
            d["max_length"], model=model, plain=loop == "plain")
        print(f"bench_decode {json.dumps(r)}")
        for name in ("greedy", "beam"):
            print(f"time serving {name} decode {loop}: {r[f'{name}_ms']} ms"
                  f" ({r[f'{name}_utts_per_s']} utts/s),"
                  f" {r[f'{name}_iterations']} iterations,"
                  f" {r[f'{name}_host_reads']} host reads,"
                  f" {r[f'{name}_kernels']} kernels, busy"
                  f" {r[f'{name}_busy_ms']} ms, idle"
                  f" {r[f'{name}_idle_share']}; graph (unroll {r['unroll']}):"
                  f" capture {r[f'{name}_capture_ms']} ms, pool"
                  f" {r[f'{name}_graph_pool_mb']} MiB,"
                  f" {r[f'{name}_graph_kernels_per_step']} kernels and"
                  f" {r[f'{name}_graph_step_us']} us a step, bound"
                  f" {r[f'{name}_step_bound_us']} us a step"
                  f" ({r[f'{name}_step_bound_by']}) [{card}]")
    for name in ("greedy", "beam"):
        hold_step_kernels(decode["graphed"], name, card, bd.REPLACED)
        print(f"time serving {name} decode plain vs graphed:"
              f" {decode['plain'][f'{name}_ms']} ms vs"
              f" {decode['graphed'][f'{name}_ms']} ms"
              f" ({decode['plain'][f'{name}_ms'] / decode['graphed'][f'{name}_ms']:.2f}x)"
              f" [{card}]")
    del model, feats
    torch.cuda.empty_cache()

    d = sc.STREAM
    model = sc.carried_model(d, SEED + 71)
    feats = sc.features(SEED + 72, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    ref, bits = sc.check_streaming(model, feats, xn, d["max_length"],
                                   d["beam"], (d["C"], 7))
    loops = sc.check_graphed_streaming(model, feats, xn, d["max_length"],
                                       d["beam"], (d["C"], 7))
    short = 64
    bits.update(sc.check_streaming(
        model, feats[:, :short].contiguous(), xn.clamp(max=short),
        d["max_length"], d["beam"], (1,))[1])
    loops.update(sc.check_graphed_streaming(
        model, feats[:, :short].contiguous(), xn.clamp(max=short),
        d["max_length"], d["beam"], (1,)))
    print(f"serving streaming at {json.dumps(d)}: chunked equals one-shot"
          f" (tokens, lengths, beam scores) at C={d['C']} and C=7 (ragged"
          f" tail), and at C=1 on the first {short} frames, through the"
          f" graphs; lengths {json.dumps(ref)}; encoder elements differing"
          f" from the whole utterance's, by C: {json.dumps(bits)}; each"
          f" session graphed equals the plain loop bit for bit:"
          f" {json.dumps(loops)}")
    for beam in (0, d["beam"]):
        chunk = {}
        for loop in ("plain", "graphed"):
            r = chunk[loop] = bs.bench_streaming(
                d["N"], d["C"], d["V"], beam, d["F"], d["H"], d["max_length"],
                model=model, plain=loop == "plain")
            print(f"bench_streaming {json.dumps(r)}")
            print(f"time serving stream beam={beam} {loop}: {r['chunk_ms']} ms"
                  f" a chunk of {d['C']} frames ({r['frames_per_s']}"
                  f" frames/s, {r['ms_per_frame_per_stream']} ms a frame a"
                  f" stream), {r['iterations_per_chunk']} iterations,"
                  f" {r['host_reads_per_chunk']} host reads, busy"
                  f" {r['busy_ms']} ms, idle {r['idle_share']}; graph"
                  f" (unroll {r['unroll']}): capture {r['capture_ms']} ms,"
                  f" pool {r['graph_pool_mb']} MiB,"
                  f" {r['graph_kernels_per_step']} kernels and"
                  f" {r['graph_step_us']} us a step [{card}]")
        print(f"time serving stream beam={beam} plain vs graphed:"
              f" {chunk['plain']['chunk_ms']} ms vs"
              f" {chunk['graphed']['chunk_ms']} ms a chunk [{card}]")
    step_entries = []
    ptxas = _build.ptxas_report("decode_step")
    # each launch's cluster (blocks that split K) at greedy's and beam's
    # rows (`decode_step.dense_plan`, `gru_plan`)
    sd = sc.DECODE
    step_plans = {
        "decode_joint": {
            dec: {"hidden": ds.dense_plan(rows, sd["H"], sd["H"], 2, True)[
                      "cluster"],
                  "logits": ds.dense_plan(rows, sd["H"], sd["V"], 2, False)[
                      "cluster"]}
            for dec, rows in (("greedy", sd["N"]),
                              ("beam", sd["N"] * sd["beam"]))},
        "decode_gru": {dec: ds.gru_plan(rows, sd["H"])["cluster"]
                       for dec, rows in (("greedy", sd["N"]),
                                         ("beam", sd["N"] * sd["beam"]))}}
    for kernel in ("decode_joint", "decode_gru"):
        greedy, beam = step_times["greedy"][kernel], step_times["beam"][kernel]
        errs_k = {cd: {dec: r[dec][name]["max_abs_err"] for dec in r
                       for name in r[dec] if name.startswith(kernel)}
                  for cd, r in step_checks.items()}
        step_entries.append({
            "name": kernel, "route": "cuda", "source": STEP_SOURCE,
            "replaces": STEP_REPLACES, "launches": step_launches[kernel],
            "max_abs_err": max(e for v in errs_k.values() for e in v.values()),
            "ms": greedy["ms"], "plain_ms": greedy["plain_ms"],
            "bound_ms": greedy["bound_ms"], "bound_by": greedy["bound_by"],
            "library_ms": None,
            "launches_a_step": {
                name: sum(n for key, n in decode["graphed"][
                    f"{name}_graph_step_kernels"].items() if kernel in key)
                for name in ("greedy", "beam")},
            "max_abs_err_by_dtype": errs_k,
            "fold_max_abs_err": max(
                [r[name]["max_abs_err"] for v in fold_checks.values()
                 for r in v.values() for name in r
                 if name.startswith(kernel)]
                + [e for e in redesign["fold"].values()]) if kernel
            == "decode_gru" else None,
            "greedy": greedy, "beam": beam,
            "odd_max_abs_err": max(c[k]["max_abs_err"] for c in odd.values()
                                   for k in c if k.startswith(kernel)),
            "wide_max_abs_err": max(e for k, e in redesign["wide"].items()
                                    if k.startswith(kernel)),
            "ring_max_abs_err": max(e for k, e in redesign["ring"].items()
                                    if k.startswith(kernel)),
            "warm_ms": greedy["warm_ms"],
            "baseline_ms": greedy["baseline_ms"],
            "baseline_warm_ms": greedy["baseline_warm_ms"],
            **{field: {
                name: {who: [sum(u for key, u in x["kernel_us"].items()
                                 if kernel in key) for x in runs]
                       for who, runs in turns[name].items()}
                for name in ("greedy", "beam")}
               for field, turns in (("in_step_us", in_turns),
                                    ("in_step_us_fold", in_turns["fold"]))},
            "cluster": step_plans[kernel],
            "ptxas": ptxas_of(ptxas, kernel)})
    beam = step_times["beam"]["decode_beam_select"]
    errs_k = {cd: {dec: r[dec]["max_abs_err"] for dec in r}
              for cd, r in select_checks.items()}
    loop_entry["launches"] = step_launches["loop_continue_kernel"]
    step_entries.append(loop_entry)
    step_entries.append({
        "name": "decode_beam_select", "route": "cuda", "source": STEP_SOURCE,
        "replaces": SELECT_REPLACES,
        "launches": step_launches["decode_beam_select"],
        "max_abs_err": max(e for v in errs_k.values() for e in v.values()),
        "ms": beam["ms"], "plain_ms": beam["plain_ms"],
        "bound_ms": beam["bound_ms"], "bound_by": beam["bound_by"],
        "library_ms": None,
        "launches_a_step": {"beam": sum(
            n for key, n in
            decode["graphed"]["beam_graph_step_kernels"].items()
            if "decode_beam_select" in key)},
        "max_abs_err_by_dtype": errs_k, "beam": beam,
        "fold_max_abs_err": max(
            [v["beam"]["decode_beam_select"]["max_abs_err"]
             for v in fold_checks.values()]
            + [r["max_abs_err"] for r in select_fold.values()]),
        "adversarial_max_abs_err": max(
            r["max_abs_err"] for r in select_odd.values()),
        "warm_ms": beam["warm_ms"], "cluster": None,
        "ptxas": ptxas_of(ptxas, "decode_beam_select")})
    return launches, errs, step_entries


def nccl_rows(rows):
    """(device ms a call, launches a call) of the profiler rows whose
    kernel names NCCL."""
    nccl = [(ms, n) for ms, n, key in rows if "nccl" in key.lower()]
    return sum(ms for ms, _ in nccl), sum(n for _, n in nccl)


def phase_parallel(torch, timing, card, train_step_ms):
    """Phase 16: the parallel tier (see the module docstring).  Returns
    ({call: {kernel: launches}}, {kernel: max abs err of the shard
    kernels against their twins})."""
    import tempfile

    import torch.distributed as dist

    from warp_rnnt_tpu_torch import rnnt_loss
    from warp_rnnt_tpu_torch.benchmarks import bench_scaling
    from warp_rnnt_tpu_torch.benchmarks import parallel_cases as pc
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
    from warp_rnnt_tpu_torch.parallel import make_mesh, rnnt_loss_sharded

    errs = {"gather_lattice": 0.0, "flat_write": 0.0}
    for name, args in pc.SHARD_CASES.items():
        for k, e in pc.compare_shards(pc.shard_case(*args)).items():
            errs[k] = max(errs[k], e)
    torch.cuda.synchronize()
    print(f"parallel vocabulary-shard kernels against their twins, exact:"
          f" {', '.join(pc.SHARD_CASES)}; halves sum to the whole")
    launches = {}
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cuda:0")
        inputs = make_inputs(torch, N, T, U, V, SEED)
        launches["nccl_1rank_main"], main_errs = pc.check_main_1rank(
            mesh, inputs)
        print(f"parallel 1-rank NCCL main path at N={N} T={T} U={U} V={V}:"
              f" costs and gradient bit-equal to rnnt_loss(gather=True);"
              f" {json.dumps(main_errs)}; launches (sharded and shard_map,"
              f" loss+grad and none) {launches['nccl_1rank_main']}")
        lp, labels, xn, yn = inputs

        def plain(x):
            x = x.detach().requires_grad_()
            rnnt_loss(x, labels, xn, yn, reduction="mean",
                      gather=True).backward()
            return None, x.grad

        def sharded(x):
            x = x.detach().requires_grad_()
            rnnt_loss_sharded(mesh, x, labels, xn, yn,
                              gather=True).backward()
            return None, x.grad

        chained = {"plain": [], "sharded": []}
        for name in ("plain", "sharded", "sharded", "plain"):
            fn = plain if name == "plain" else sharded
            chained[name].append(timing.bench_grad_chain(fn, lp, 10))
        prof = {name: profile_step(lambda f=fn: f(lp))
                for name, fn in (("plain", plain), ("sharded", sharded))}
        for name, p in prof.items():
            nccl_ms, nccl_n = nccl_rows(p["rows"])
            print(f"time parallel main path {name}: {chained[name]} ms"
                  f" chained (in turns), {p['kernels_per_call']} kernels a"
                  f" call, busy {p['busy_ms']:.4f} ms, idle"
                  f" {p['idle_share']:.3f}, NCCL kernels {nccl_n} a call"
                  f" {nccl_ms:.4f} ms [{card}]")
        for ms, count, key in prof["sharded"]["rows"][:12]:
            print(f"profile parallel sharded {ms:.4f} ms/call {count} x/call"
                  f" {key[:80]}")
        del inputs, lp, prof
        torch.cuda.empty_cache()
        lps = bench_scaling.lattices_per_second(mesh)
        print(f"bench_scaling {json.dumps({'ranks': 1, 'lattices_per_s': lps})}"
              f" [{card}]")

        mesh2 = make_mesh((1, 1), ("data", "model"), device="cuda:0")
        for mode in TRAIN_MODES:
            r = pc.check_train_step(mesh2, mode)
            launches[f"train_1x1_{mode}"] = r["launches"]
            launches[f"train_1x1_{mode}_vocab_route"] = r["vocab_launches"]
            ms = timing.bench_grad_chain(
                lambda _, r=r: (None, r["step"](r["batch"])), None, 10)
            print(f"time parallel train step {mode} on a 1x1 mesh: {ms:.3f}"
                  f" ms chained against phase 14's {train_step_ms[mode]:.3f};"
                  f" gradients at {r['grads']:.3f} of their allowance,"
                  f" parameters within {r['moved']:.2e} after one AdamW"
                  f" step; launches {r['launches']}; the vocabulary route"
                  f" called on its own: gradients at {r['vocab_grads']:.3f}"
                  f" of their allowance, launches {r['vocab_launches']}"
                  f" [{card}]")
            del r
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = pc.run_world(tmp)
    for r in ranks[1:]:
        if r["dryrun"] != ranks[0]["dryrun"]:
            raise AssertionError("2x2 world: dry-run losses differ by rank")
    for case, n in ranks[0]["launches"].items():
        launches[f"gloo_2x2_{case}"] = n
    print(f"parallel 2x2 gloo world on one card: {time.perf_counter() - t0:.1f}"
          f" s; errors {json.dumps(ranks[0]['errs'])}; dryrun"
          f" {json.dumps(ranks[0]['dryrun'])}; launches (rank 0)"
          f" {json.dumps(ranks[0]['launches'])}; seconds by rank"
          f" {[r['s'] for r in ranks]}")
    worst = {k: max(r["errs"][k] for r in ranks) for k in ranks[0]["errs"]}
    print(f"parallel 2x2 largest errors over the ranks: {json.dumps(worst)}")
    return launches, errs


# ---- slice 13: the benchmark tier -------------------------------------------


def phase_benchmarks(torch, card):
    """Phase 17: the benchmark tier (see the module docstring).  Returns
    ({call: {kernel: launches}}, {kernel: max abs err})."""
    import gc
    import tempfile

    from warp_rnnt_tpu_torch.benchmarks import bench_cases as bc
    from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
    from warp_rnnt_tpu_torch.benchmarks import bench_loss as bl
    from warp_rnnt_tpu_torch.benchmarks import run_table as rt

    t0 = time.perf_counter()
    print(f"bench_loss headline {json.dumps(bl.headline())}")
    # the table's children need the card's memory: hand the cache back
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**20
    print(f"run_table: this process holds {held:.0f} MiB of the card")
    with tempfile.TemporaryDirectory() as tmp:
        doc = rt.main(os.path.join(tmp, "table.json"))
    bad = [r for r in doc["rows"] if "error" in r or "loss_grad_ms" not in r]
    if len(doc["rows"]) != len(rt.table_rows()) or bad:
        raise AssertionError(f"run_table: failed rows {bad}")
    print(f"run_table: {len(doc['rows'])} rows,"
          f" {time.perf_counter() - t0:.1f} s [{card}]")

    write_ms = {}
    for T_, U_, V_ in rt.REFERENCE_GATHER_MS:  # where each config's time goes
        for call, r in bl.profile_row(128, T_, U_, V_, seed=SEED).items():
            if call == "loss_grad":
                ms = [ms for ms, _, key in r["rows"]
                      if bc.MAIN_SYMBOLS["flat_write"] in key]
                if not r["complete"] or len(ms) != 1:
                    raise AssertionError(
                        f"profile table T={T_} U={U_} V={V_} N=128 loss+grad:"
                        f" complete {r['complete']}, {len(ms)} flat_write rows;"
                        f" no device ms for the write")
                write_ms[f"T={T_} U={U_} V={V_} N=128"] = ms[0]
            print(f"profile table T={T_} U={U_} V={V_} N=128 {call}:"
                  f" {r['step_ms']:.4f} ms without the profiler,"
                  f" {r['kernels_per_call']} kernels a call, busy"
                  f" {r['busy_ms']:.4f} ms, idle {r['idle_share']:.3f}"
                  f" (complete {r['complete']}, {r['attempts']} session(s),"
                  f" pad lost {r['pad_lost']}); top:"
                  + "; ".join(f"{ms:.4f} ms x{k} {key[:60]}"
                              for ms, k, key in r["rows"][:4]) + f" [{card}]")
        torch.cuda.empty_cache()

    launches, errs = {}, {}
    for T_, U_, V_ in rt.REFERENCE_GATHER_MS:
        e, n = bc.check_table_row(T_, U_, V_, N=1, seed=SEED)
        tag = f"table T={T_} U={U_} V={V_} N=1"
        launches[f"{tag} loss+grad"] = n["loss_grad"]
        launches[f"{tag} no-grad"] = n["no_grad"]
        for k in ("gather_lattice", "flat_write"):
            errs[k] = max(errs.get(k, 0.0), e[k])
        print(f"{tag} against the scan: {json.dumps(e)} (costs rtol"
              f" {bc.COST_RTOL}, gradient {bc.GRAD_TOL} of the largest;"
              f" gather_lattice and flat_write against their plain versions"
              f" exactly); launches {json.dumps(n)}")
    torch.cuda.empty_cache()
    e, n = bc.check_long_lattice(seed=SEED)
    errs.update(e)
    launches.update({f"long lattice {k}": v for k, v in n.items()})
    print(f"long lattice (128, 1500, 301), samples 0, 1, 64, 127 against the"
          f" float64 twin: max abs err on valid cells {json.dumps(e)};"
          f" launches {json.dumps(n)}")
    torch.cuda.empty_cache()

    for rand in (False, True):
        e, n, routes = bc.check_joint_modes(**bj.DEFAULTS, rand_length=rand,
                                            seed=SEED)
        tag = "random lengths" if rand else "full lengths"
        launches.update({f"joint {m} {tag}": k for m, k in n.items()})
        print(f"bench_joint modes at {json.dumps(bj.DEFAULTS)}, {tag}, against"
              f" log_softmax+gather (loss rtol {bc.MODE_LOSS_RTOL}, gradients"
              f" {bc.MODE_GRAD_TOL} of the largest): {json.dumps(e)}; routes"
              f" {json.dumps(routes)}; launches {json.dumps(n)}")
        for mode in bj.MODES:
            r = bj.bench_joint(mode=mode, rand_length=rand, seed=SEED,
                               **bj.DEFAULTS)
            print(f"bench_joint {json.dumps(r)}")
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rows = bc.trace_main_path(tmp, calls=3, seed=SEED)
    missing = bc.missing_symbols(rows)
    if missing:
        raise AssertionError(f"trace of the main path lacks {missing}: {rows}")
    for us, name in rows:
        print(f"op_breakdown main path, 3 calls: {us:.1f} us {name[:80]}")
    print(f"phase 17: {time.perf_counter() - t0:.1f} s; flat_write device ms"
          f" a loss+grad at the N=128 rows {json.dumps(write_ms)} [{card}]")
    return launches, errs, write_ms


def wall_ms(torch, fn, iters=20, warmup=3):
    """Host wall ms a call of ``fn()`` over ``iters`` calls, the device
    synchronized before and after (the TF bridge synchronizes on every
    crossing, so the chained timers do not apply to it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def tensorflow_line():
    """Whether TensorFlow is installed (`find_spec` alone decides), and its
    version and CUDA build from a child process where it is."""
    import importlib.util
    import subprocess

    if importlib.util.find_spec("tensorflow") is None:
        return False, ("tensorflow: not installed (importlib.util.find_spec"
                       " finds none); phase 18 runs the bridge's torch half"
                       " only")
    out = subprocess.run(
        [sys.executable, "-c", "import tensorflow as tf; print(tf.__version__,"
         " tf.test.is_built_with_cuda())"],
        capture_output=True, text=True, timeout=300, check=True)
    return True, f"tensorflow: {out.stdout.strip().splitlines()[-1]}"


def phase_tf_binding(torch, card):
    """Phase 18: the TensorFlow front end (see the module docstring).
    Returns ({call: {kernel: launches}}, {call: its errors})."""
    from warp_rnnt_tpu_torch.benchmarks import bridge_cases as bc
    from warp_rnnt_tpu_torch.bindings import _bridge

    t0 = time.perf_counter()
    has_tf, line = tensorflow_line()
    print(line)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    inputs = make_inputs(torch, N, T, U, V, SEED + 18)
    launches, errs = {}, {}
    for blank in (0, -1):
        e, n = bc.check_bridge(*inputs, blank=blank)
        launches[f"bridge blank={blank}"] = n
        errs[f"bridge blank={blank}"] = e
        print(f"bridge torch half blank={blank} at {(N, T, U, V)}: against"
              f" the plain version {json.dumps(e)} (costs rtol"
              f" {bc.COST_RTOL}, gradient {bc.GRAD_TOL} of the largest;"
              f" direct loss+grad bit for bit); launches {json.dumps(n)}")
    xs, ys, xn, yn = inputs
    ms = {"bridge": wall_ms(torch, lambda: _bridge.transducer_costs_and_grads(
              xs, ys, xn, yn)),
          "direct": wall_ms(torch, lambda: bc.direct_sum(xs, ys, xn, yn))}
    print(f"bridge torch half ms {ms['bridge']:.4f}, direct loss+grad ms"
          f" {ms['direct']:.4f} (host wall, 20 calls) [{card}]")
    if has_tf:
        tf_launches, tf_errs = tf_bridge_on_card(torch, bc, inputs, card)
        launches.update(tf_launches)
        errs.update(tf_errs)
    del inputs, xs
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; torch peak"
          f" {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]")
    torch.cuda.empty_cache()
    return launches, errs


def tf_bridge_on_card(torch, bc, inputs, card):
    """Phase 18 where TensorFlow is installed: the TF bridge on GPU tensors
    against the direct torch calls, bit for bit, timed beside them.
    Returns ({call: {kernel: launches}}, {call: its errors})."""
    import tensorflow as tf

    from warp_rnnt_tpu_torch.benchmarks import bench_joint as bj
    from warp_rnnt_tpu_torch.bindings import tf_binding as tfb

    for gpu in tf.config.list_physical_devices("GPU"):
        tf.config.experimental.set_memory_growth(gpu, True)
    launches, errs = {}, {}
    for blank in (0, -1):
        e, n = bc.check_tf_bridge(tf, tfb, *inputs, blank=blank)
        launches[f"tf rnnt_loss blank={blank}"] = n
        errs[f"tf rnnt_loss blank={blank}"] = e
        print(f"TF bridge blank={blank}: {json.dumps(e)}; launches"
              f" {json.dumps(n)}")
    xs, ys, xn, yn = inputs
    args = [tfb._to_tf(xs), *bc.tf_ints(tf, ys, xn, yn)]
    ms_tf = wall_ms(torch, lambda: bc.tf_loss_grad(tf, tfb, *args))
    ms_direct = wall_ms(torch, lambda: bc.direct_sum(xs, ys, xn, yn))
    print(f"TF bridge loss+grad ms {ms_tf:.4f}, direct {ms_direct:.4f}:"
          f" overhead {ms_tf - ms_direct:.4f} ms [{card}]")
    d = bj.DEFAULTS
    f, g, jys, jxn, jyn = bj.make_inputs(SEED + 18, d["N"], d["T"], d["U"],
                                         d["H"], rand_length=True)
    tree = bj.joint_tree(SEED + 18, d["H"], d["V"])["params"]
    weights = [torch.tensor(tree[layer][k], device="cuda")
               for layer in ("pre", "out") for k in ("kernel", "bias")]
    e, n = bc.check_tf_joint(tf, tfb, f, g, weights, jys, jxn, jyn)
    launches["tf rnnt_loss_fused_joint"] = n
    errs["tf rnnt_loss_fused_joint"] = e
    print(f"TF fused joint at {json.dumps(d)}: {json.dumps(e)}; launches"
          f" {json.dumps(n)}")
    info = tf.config.experimental.get_memory_info("GPU:0")
    print(f"TF allocator peak {info['peak'] / 2**20:.0f} MiB, torch peak"
          f" {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]")
    return launches, errs


# The compiled loss+grad's rows: bench.py's headline (L = 20 labels) and the
# README table's configurations at N = 1 and 128.
COMPILED_TABLE = ((150, 40, 28), (150, 20, 5000), (1500, 300, 50))
HEADLINE_KERNELS = 10  # an eager headline loss+grad's launches (phase 13)
JOINT_STEP = dict(N=16, T=150, U=20, V=5000, H=256)  # bench_joint's defaults


def phase_compiled_main(torch, card):
    """The main path compiled (`utils.compiled_step`, see the module
    docstring): `benchmarks/compiled_cases.py` at the headline (fp32 in
    every variant with a replay's profile, bf16, the flat layout) and the
    six table rows.  Returns {row: check_row's numbers}."""
    from warp_rnnt_tpu_torch.benchmarks import compiled_cases as cc
    from warp_rnnt_tpu_torch.benchmarks import run_table as rt
    from warp_rnnt_tpu_torch.utils import compiled_step as cs

    t0 = time.perf_counter()
    rows = [("headline", dict(N=N, T=T, L=U - 1, V=V, variants=tuple(
        cc.VARIANTS), profile=True)),
            ("headline bf16", dict(N=N, T=T, L=U - 1, V=V,
                                   dtype=torch.bfloat16,
                                   variants=tuple(cc.VARIANTS))),
            ("headline flat", dict(N=N, T=T, L=U - 1, V=V, flat=True,
                                   variants=tuple(cc.VARIANTS)))]
    rows += [(f"table T={T_} L={L_} V={V_} N={n}", dict(N=n, T=T_, L=L_, V=V_))
             for T_, L_, V_ in COMPILED_TABLE for n in (1, 128)]
    out = {}
    for name, kw in rows:
        r = cc.check_row(iters=rt.iters_for(kw["T"], kw["L"]), seed=SEED, **kw)
        kernels = r.pop("kernels", None)
        if kernels is not None:
            n = sum(kernels["compiled"].values())
            if n != HEADLINE_KERNELS:
                raise AssertionError(f"compiled headline: a replay launches {n}"
                                     f" kernels, not {HEADLINE_KERNELS}:"
                                     f" {kernels['compiled']}")
            r["kernels_a_replay"] = n
        out[name] = r
        print(f"compiled {name}: equal to eager bit for bit (loss, gradient,"
              f" costs; {', '.join(kw.get('variants', ('mean',)))}) on the"
              f" capture's log-probs and on new ones; {json.dumps(r)} [{card}]")
        torch.cuda.empty_cache()
    n = cc.check_canary()
    print(f"compiled canary: WARP_RNNT_DEBUG=1, {n} warnings in 2 tripped"
          f" calls; none without it; cache {len(cs.entries())} entries,"
          f" {cs.STATS}")
    print(f"phase compiled main: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


# the port's kernels by a word of their names in a trace
OUR_KERNELS = (("prefix_kernel", "packed_gather"),
               ("lattice_gather_kernel", "packed_gather"),
               ("packed_scatter_kernel", "packed_scatter"),
               ("hidden_image_kernel", "fused_joint_hidden"),
               ("dadc_kernel", "fused_joint_bwd_dadc"),
               ("dwdb_kernel", "fused_joint_bwd_dwdb"),
               ("fwd_kernel", "fused_joint_fwd"),
               ("epilogue_kernel", "lattice_epilogue"),
               ("lattice_kernel", "lattice_fused"),
               ("flat_write_kernel", "flat_write"),
               ("column_gather_kernel", "gather_lattice"),
               ("decode_joint", "decode_joint"), ("decode_gru", "decode_gru"),
               ("decode_beam_select", "decode_beam_select"),
               ("loop_continue_kernel", "loop_continue_kernel"))


def ours(kernels):
    """{port kernel: launches a call} of a profile's {kernel: launches}."""
    out = {}
    for key, n in kernels.items():
        for word, name in OUR_KERNELS:
            if word in key:
                out[name] = out.get(name, 0) + n
                break
    return out


def phase_compiled_serving(torch, card):
    """The streaming chunk and the joint step compiled
    (`benchmarks/compiled_serving_cases.py`): at bench_streaming's width,
    greedy and beam, compiled chunks equal to eager ones, chunked equal to
    one-shot with a ragged tail, two interleaved sessions each equal to
    its one-shot decode; at bench_joint's shape, full and random lengths,
    the compiled step equal to eager in its five modes (compact with its
    static bounds), and compact without them refused.  Returns
    {"stream": {decoder: port kernels a
    compiled chunk}, "joint": {mode: port kernels a replay}}."""
    from warp_rnnt_tpu_torch.benchmarks import bench_streaming as bs
    from warp_rnnt_tpu_torch.benchmarks import compiled_decode_cases as cdc
    from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
    from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import device_profile
    from warp_rnnt_tpu_torch.models import stream_init, stream_step, streaming
    from warp_rnnt_tpu_torch.models import decoding

    t0 = time.perf_counter()
    d = sc.STREAM
    T = 150  # chunks of 16 leave a ragged tail of 6
    model = sc.carried_model(d, SEED + 81)
    feats = sc.features(SEED + 82, d["N"], T, d["F"])
    other = sc.features(SEED + 83, d["N"], T, d["F"])
    xn = sc.ragged(d["N"], T)
    for beam in (0, d["beam"]):
        for x in (xn, None):
            r = csc.check_stream_compiled(model, feats, x, d["max_length"],
                                          beam, d["C"])
            print(f"compiled stream beam={beam} C={d['C']} T={T}"
                  f"{' ragged xn' if x is not None else ''}: every chunk's"
                  f" state and the finish equal eager bit for bit;"
                  f" {json.dumps(r)}")
    ref, bits = sc.check_streaming(model, feats, xn, d["max_length"],
                                   d["beam"], (d["C"],))
    print(f"compiled stream: chunked (C={d['C']}, tail 6, finish) equals"
          f" one-shot, greedy and beam {d['beam']}; lengths {json.dumps(ref)};"
          f" encoder elements differing {json.dumps(bits)}")
    for beam in (0, d["beam"]):
        lengths = csc.check_interleaved(model, (feats, other),
                                        (xn, xn.flip(0)), d["max_length"],
                                        beam, d["C"])
        print(f"compiled stream beam={beam}: two interleaved sessions of"
              f" (N, C) = ({d['N']}, {d['C']}) each equal their one-shot"
              f" decode; lengths {json.dumps(lengths)}")
    stream = {}
    for beam, name in ((0, "greedy"), (d["beam"], "beam")):
        box = [stream_init(model, d["N"], d["max_length"], beam_size=beam)]
        chunk = feats[:, :d["C"]].contiguous()
        for _ in range(d["max_length"] // d["C"] + 4):  # token buffers full
            box[0] = stream_step(model, box[0], chunk)

        def one():
            box[0] = stream_step(model, box[0], chunk)

        reads = decoding.HOST_READS[name]
        iterations = decoding.LOOP_ITERATIONS[name]
        for _ in range(3):
            one()
        reads = (decoding.HOST_READS[name] - reads) / 3
        iterations = (decoding.LOOP_ITERATIONS[name] - iterations) // 3
        if reads != 1:
            raise AssertionError(f"compiled {name} chunk: {reads} host reads")
        one()
        stream[name] = ours(cdc.call_launches(streaming.LAST_GRAPH["step"]))
        rounds = [loop.rounds for loop in streaming.LAST_GRAPH["step"].loops]
        prof = device_profile(one, 10)
        rows = {key: n for _, n, key in prof["rows"]}
        whole = device_profile(streaming.LAST_GRAPH["step"].replay, 10)
        wheres = sum(n for key, n in rows.items() if "where" in key.lower())
        print(f"compiled stream {name} chunk: {reads} host reads a chunk,"
              f" {prof['kernels_per_call']} kernels a chunk, busy"
              f" {prof['busy_ms']} ms, idle {prof['idle_share']}; the port's"
              f" on the card, read from the chunk graph and its loop's"
              f" {rounds} rounds counted on the card ({iterations}"
              f" iterations) {json.dumps(stream[name])} (in the profile,"
              f" which misses records inside the while node's body,"
              f" {json.dumps(ours(rows))});"
              f" where kernels a chunk {wheres} (the drain's loop folded);"
              f" the chunk graph's replay alone {whole['kernels_per_call']}"
              f" kernels, busy {whole['busy_ms']} ms [{card}]")
    print(f"compiled stream chunk graphs: (capture ms, pool MiB)"
          f" {json.dumps(bs.chunk_graphs())}")
    del model, feats, other
    torch.cuda.empty_cache()

    joint = {}
    for rand in (False, True):
        case = csc.joint_case(**JOINT_STEP, rand_length=rand, seed=SEED + 84)
        for mode in csc.JOINT_MODES:
            r = csc.check_joint(mode, *case, seed=SEED, profile=not rand)
            if not rand:
                k = r.pop("kernels")
                ms = r.pop("kernel_ms")
                r["slower_compiled_us"] = {
                    key[:60]: round((t - ms["eager"].get(key, 0.0)) * 1e3, 2)
                    for key, t in sorted(
                        ms["compiled"].items(),
                        key=lambda kv: ms["eager"].get(kv[0], 0.0) - kv[1])[:3]}
                joint[mode] = ours(k["compiled"])
                r["kernels_a_replay"] = sum(k["compiled"].values())
                r["kernels_eager"] = sum(k["eager"].values())
                r["port_kernels_a_replay"] = joint[mode]
            print(f"compiled joint {mode} {json.dumps(JOINT_STEP)}"
                  f"{' random lengths' * rand}: loss and four gradients"
                  f" equal eager bit for bit on the capture's inputs and on"
                  f" new ones; {json.dumps(r)} [{card}]")
            torch.cuda.empty_cache()
        if rand:
            why = csc.check_compact_needs_bounds(*case)
            print(f"compiled joint compact without static bounds: its"
                  f" capture raised; {why}")
        del case
    print(f"phase compiled serving: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"stream": stream, "joint": joint}


def phase_compiled_decode(torch, card):
    """A whole decode and a whole streaming chunk compiled, the drain's
    while node inside the graph (`benchmarks/compiled_decode_cases.py`):
    at bench_decode's width (N=32, T=400, V=1024, hidden 512, ragged
    lengths) the compiled greedy and beam 4 decodes against the eager
    decode and the plain loop bit for bit (cond false at entry included),
    one replay and one host read a call, one conditional node; a loop
    past its bound raising after its replay; a held loop through
    `device_loop.clear()` and eviction; a compiled train step's updates
    reaching the next compiled decode; at bench_streaming's width (N=8,
    C=16, ragged tail) compiled sessions against eager and plain, two
    interleaved sessions; then the compiled and eager decode and chunk
    timed a call in turns beside the while launch alone.  Returns
    {"launches": {call: {kernel: launches}} with the counts set to 0 just
    before the compiled decode's first call (its capture) and read just
    after, "replay": {decoder: port kernels a steady compiled call, read
    from its graphs and its loop's rounds counted on the card
    (`compiled_decode_cases.call_launches`)}}."""
    from warp_rnnt_tpu_torch.benchmarks import compiled_decode_cases as cdc
    from warp_rnnt_tpu_torch.benchmarks import compiled_serving_cases as csc
    from warp_rnnt_tpu_torch.benchmarks import serving_cases as sc
    from warp_rnnt_tpu_torch.benchmarks import train_cases as tc
    from warp_rnnt_tpu_torch.benchmarks.decode_turns import (
        launch_ms,
        recorded_loops,
    )
    from warp_rnnt_tpu_torch.models import beam_search, decoding

    t0 = time.perf_counter()
    d = sc.DECODE
    model = sc.carried_model(d, SEED + 91)
    feats = sc.features(SEED + 92, d["N"], d["T"], d["F"])
    xn = sc.ragged(d["N"], d["T"])
    full = torch.full((d["N"],), d["T"], dtype=torch.int32, device="cuda")
    L = d["max_length"]
    launches, replay = {}, {}
    with torch.inference_mode():
        for beam, name in ((0, "greedy"), (d["beam"], "beam")):
            fn = cdc.decoder(beam)[0]
            launches[f"compiled {name} decode"] = sc.launched(
                lambda: fn(model, feats, full, L))[1]
            r = cdc.steady(lambda: fn(model, feats, full, L), name)
            missing = [k for k in (*STEP_OF[name], "loop_continue_kernel")
                       if not launches[f"compiled {name} decode"].get(k)]
            if missing:
                raise AssertionError(f"compiled {name} decode launched no"
                                     f" {missing}")
            entry = cdc.entry_of(cdc.decoder(beam)[2])
            replay[name] = ours(cdc.call_launches(entry))
            missing = [k for k in (*STEP_OF[name], "loop_continue_kernel")
                       if not replay[name].get(k)]
            if missing:
                raise AssertionError(f"a steady compiled {name} decode"
                                     f" launched no {missing} on the card")
            print(f"compiled {name} decode at {json.dumps(d)}: launches in"
                  f" its first call (warm-up and capture)"
                  f" {json.dumps(launches[f'compiled {name} decode'])}; a"
                  f" steady call {json.dumps(r)}, its launches on the card"
                  f" (read from its graph, its loop's"
                  f" {[loop.rounds for loop in entry.loops]} rounds counted"
                  f" on the card) {json.dumps(replay[name])}")
    for beam in (0, d["beam"]):
        r = cdc.check_decode(model, feats, xn, L, beam)
        print(f"compiled decode beam={beam} at {json.dumps(d)}, ragged"
              f" lengths: equal to the eager decode and to the plain loop"
              f" bit for bit on the capture's call, a replay on other"
              f" features and a replay with every length 0 (cond false at"
              f" entry); a steady call {json.dumps(r['steady'])}, rounds"
              f" counted on the card {r['rounds']}, the port's launches"
              f" {json.dumps(ours(r['launches']))}; runtime"
              f" calls a call {json.dumps(r['runtime_calls'])}; the outer"
              f" graph's nodes {json.dumps(r['kinds'])}; capture"
              f" {r['capture_ms']:.1f} ms, pool {r['pool_mib']:.1f} MiB")
    bound = cdc.check_bound()
    print(f"compiled loop past its bound: raised after its replay with the"
          f" eager loop's error, the next call right: {json.dumps(bound)}")
    evicted = cdc.check_held(model, feats, xn, L)
    print(f"compiled decode's loop held: replays equal after"
          f" device_loop.clear() and after the cache's eviction ({evicted}"
          f" entry left)")
    change = cdc.check_update(tc.SMALL, SEED + 93)
    print(f"compiled decode after a compiled train step (two calls, in-place"
          f" updates) at {json.dumps(tc.SMALL)}: equal to the eager decode on"
          f" the updated weights; beam scores moved by up to {change:.3e}")
    for name, beam in (("greedy", 0), ("beam", d["beam"])):
        with recorded_loops() as seen, torch.inference_mode():
            (beam_search.beam_decode(model, feats, full, L, beam_size=beam)
             if beam else decoding.greedy_decode(model, feats, full, L))
            alone = launch_ms(*seen[-1], 3)[0]
        t = cdc.decode_times(model, feats, full, L, beam)
        low = min(t["compiled"])
        if low < min(alone):
            raise AssertionError(f"compiled {name} decode read {low} ms, under"
                                 f" its while launch alone ({min(alone)})")
        print(f"time compiled {name} decode at {json.dumps(d)}, events a"
              f" call, in turns with the eager decode (eager, compiled,"
              f" compiled, eager, 10 calls each): compiled"
              f" {json.dumps(cdc.summary(t['compiled']))}, eager"
              f" {json.dumps(cdc.summary(t['eager']))} ms; the while launch"
              f" alone {min(alone):.3f}-{max(alone):.3f} ms; the compiled"
              f" graph's replay alone {t['replay_ms']:.3f} ms (idle share"
              f" {1 - t['replay_ms'] / cdc.median(t['compiled']):.3f} of the"
              f" median call); under the profiler busy {t['busy_ms']} ms,"
              f" idle {t['idle_share']}, {t['kernels']} kernels a call"
              f" [{card}]")
    del model, feats
    torch.cuda.empty_cache()

    sd = sc.STREAM
    T = 150  # chunks of 16 leave a ragged tail of 6
    model = sc.carried_model(sd, SEED + 94)
    feats = sc.features(SEED + 95, sd["N"], T, sd["F"])
    other = sc.features(SEED + 96, sd["N"], T, sd["F"])
    xn = sc.ragged(sd["N"], T)
    for beam in (0, sd["beam"]):
        r = cdc.check_chunk(model, feats, xn, sd["max_length"], beam,
                            sd["C"])
        lengths = csc.check_interleaved(model, (feats, other),
                                        (xn, xn.flip(0)), sd["max_length"],
                                        beam, sd["C"])
        print(f"compiled chunk beam={beam} (N, C) = ({sd['N']}, {sd['C']}),"
              f" T={T}: every chunk's state and the finish equal the eager"
              f" and the plain sessions bit for bit; a steady chunk"
              f" {json.dumps(r['steady'])}, the port's launches"
              f" {json.dumps(ours(r['launches']))}; runtime calls a chunk"
              f" {json.dumps(r['runtime_calls'])}; the outer graph's nodes"
              f" {json.dumps(r['kinds'])}; two interleaved sessions equal"
              f" their one-shot decodes, lengths {json.dumps(lengths)}")
        t = cdc.chunk_times(model, feats[:, :sd["C"]].contiguous(),
                            sd["max_length"], beam)
        print(f"time compiled chunk beam={beam} (N, C) = ({sd['N']},"
              f" {sd['C']}), token buffers full, events a call, in turns"
              f" with the eager chunk: compiled"
              f" {json.dumps(cdc.summary(t['compiled']))}, eager"
              f" {json.dumps(cdc.summary(t['eager']))} ms; the compiled"
              f" graph's replay alone {t['replay_ms']:.3f} ms (idle share"
              f" {1 - t['replay_ms'] / cdc.median(t['compiled']):.3f} of the"
              f" median call); under the profiler busy {t['busy_ms']} ms,"
              f" idle {t['idle_share']}, {t['kernels']} kernels a chunk"
              f" [{card}]")
    del model, feats, other
    torch.cuda.empty_cache()
    print(f"phase compiled decode: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"launches": launches, "replay": replay}


def phase_compiled_train(torch, card):
    """The train step and the compact loss compiled
    (`benchmarks/compiled_train_cases.py`): at bench_train's width
    (`train_cases.FULL`) in each loss mode, from a fresh model and
    optimizer, the first compiled call equal to one eager step of the same
    capturable AdamW, 5 calls to 5 eager steps (bit for bit, or where two
    eager runs differ within `compare_steps`' tolerance, the differing
    tensors named), the loss falling, the step against the eager
    non-capturable step within `train_cases.STEP_ATOL`, each mode's graph
    released before the next; compact A and B compiled with static
    bounds against eager bit for bit, with the kernels of each replay.
    Returns {"train": {mode: check_train's numbers}, "compact": {case:
    {"loss_grad", "no_grad", "eager": port kernels a call}}}."""
    from warp_rnnt_tpu_torch.benchmarks import compiled_train_cases as ctc
    from warp_rnnt_tpu_torch.benchmarks import packed_cases as pc
    from warp_rnnt_tpu_torch.benchmarks import train_cases as tc

    t0 = time.perf_counter()
    out = {"train": {}, "compact": {}}
    for mode in TRAIN_MODES:
        r = ctc.check_train(mode, tc.FULL, seed=SEED + 91, K=TRAIN_STEPS)
        out["train"][mode] = r
        how = ("bit for bit" if r["bit_for_bit"] else
               f"within compare_steps' tolerance, {r['worst_step']:.2e} where"
               f" the gradients agree; two eager runs differ in"
               f" {r['eager_differs']}")
        print(f"compiled train {mode} at {json.dumps(tc.FULL)}: the first"
              f" call applies exactly one AdamW update and {TRAIN_STEPS} calls"
              f" equal {TRAIN_STEPS} eager steps of the same capturable AdamW"
              f" ({how}); the loss falls {r['losses']}; against the eager"
              f" non-capturable step: {r['vs_non_capturable'][0]:.2e} on the"
              f" {r['vs_non_capturable'][1]:.3f} of entries whose gradients"
              f" agree (allowance {tc.STEP_ATOL:.0e}); capture"
              f" {r['capture_ms']:.1f} ms, pool {r['pool_mib']:.1f} MiB"
              f" [{card}]")
        torch.cuda.empty_cache()
    for label, dims in (("A", CASE_A), ("B", CASE_B)):
        case = pc.full_case(**dims, seed=SEED)
        r = ctc.check_compact(case)
        kernels = r.pop("kernels")
        r["kernels_a_call"] = {k: sum(v.values()) for k, v in kernels.items()}
        port = {k: ours(v) for k, v in kernels.items()}
        # the no-grad graph's sweep is the beta-only grid of lattice_kernel
        port["no_grad"] = {("lattice_beta_only" if k == "lattice_fused"
                            else k): n for k, n in port["no_grad"].items()}
        out["compact"][label] = r["port_kernels"] = port
        print(f"compiled compact case {label} (T={case['T']}, U={case['U']},"
              f" static bounds): loss, packed gradient and no-grad costs"
              f" equal eager bit for bit; {json.dumps(r)} [{card}]")
        del case
        torch.cuda.empty_cache()
    print(f"phase compiled train: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "warp_rnnt_tpu_torch")):
        print("chip_smoke: warp_rnnt_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import warp_rnnt_tpu_torch as wt
    from warp_rnnt_tpu_torch.benchmarks import fused_joint_cases as fj_cases
    from warp_rnnt_tpu_torch.benchmarks import timing
    from warp_rnnt_tpu_torch.functional.loss import _labels_ext
    import numpy as np

    from warp_rnnt_tpu_torch.functional.gather import gather_blank_label_plain
    from warp_rnnt_tpu_torch.functional.postprocess import costs_and_grads
    from warp_rnnt_tpu_torch.models import carry_flax_joint
    from warp_rnnt_tpu_torch.ops import _build, cuda_impl
    from warp_rnnt_tpu_torch.benchmarks import epilogue_cases as ec
    from warp_rnnt_tpu_torch.benchmarks import flat_write_cases as fwc
    from warp_rnnt_tpu_torch.ops import flat_kernels as fk
    from warp_rnnt_tpu_torch.ops import fused_joint as fj
    from warp_rnnt_tpu_torch.ops import gather_kernels as gk
    from warp_rnnt_tpu_torch.utils.profiling import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    rates = timing.card_rates(kind)
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    _build.build_all((*_build.SOURCES, *_build.YARDSTICKS))
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_build.SOURCES)}"
          f" sources and {len(_build.YARDSTICKS)} yardstick in parallel)")

    inputs = make_inputs(torch, N, T, U, V, SEED)
    log_probs, labels, xn, yn = inputs
    loc_rows = _labels_ext(labels, 0)
    idx = loc_rows.long()[:, None, :, None].expand(N, T, U, 1)
    main_lattice = (log_probs[..., 0].contiguous(),
                    torch.gather(log_probs, 3, idx)[..., 0].contiguous(), xn, yn)

    errs = phase_lattice(torch, cuda_impl, main_lattice)
    ns = cuda_impl.lae_ns()
    print(f"one dependent logaddexp on one thread: {ns} ns [{card}]")
    ct = (*phase_write(torch, fk, fwc, loc_rows), loc_rows)
    errs["flat_write"] = 0.0
    errs["lattice_epilogue"] = phase_epilogue(torch, ec, cuda_impl, fk)

    launches, loss, grad, loss3, grad3, costs_ng = phase_main(
        torch, wt, [cuda_impl.LAUNCHES, fk.LAUNCHES, gk.LAUNCHES], inputs
    )
    check_main(torch, wt, inputs, loss, grad, loss3, grad3, costs_ng)
    check_previous_formulation(torch, wt, fk, gather_blank_label_plain, inputs,
                               loss.detach(), grad, "N=32")
    del loss, grad, loss3, grad3
    check_plain_epilogue(torch, wt, cuda_impl, inputs)
    check_golden(torch, wt)
    errs["lattice_fused"] = max(errs["lattice_fused"], phase_neg_inf(
        torch, np, wt, cuda_impl, costs_and_grads))

    times = phase_times(torch, wt, cuda_impl, fk, timing, inputs, main_lattice,
                        ct, rates, card, ns)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del inputs, log_probs, main_lattice, ct
    torch.cuda.empty_cache()
    phase_compiled_main(torch, card)

    # the fused joint slice: rnnt_loss_fused_joint at N=16 T=150 U=21 V=5000
    # H=F=256, weights carried from a Flax-layout tree made from the seed
    joint, params = carry_flax_joint(fj_tree(np, SEED), device="cuda")
    fjin = fj_inputs(torch, SEED + 1)
    full_case = fj_full_case(torch, fj, fjin, params)
    errs.update(phase_fused_kernels(torch, fj, fj_cases, full_case))
    check_deterministic(torch, fj, full_case, "full width")
    attrs = kernel_attrs(fj)
    attrs["lattice_fused"] = attrs["lattice_beta_only"] = lattice_attrs(cuda_impl)
    attrs["lattice_epilogue"] = epilogue_attrs(_build)
    fj_launches, *fj_out = phase_fused_main(
        torch, wt, [cuda_impl.LAUNCHES, fk.LAUNCHES, fj.LAUNCHES], fjin, params
    )
    check_fused_main(torch, wt, fj_cases, joint, fjin, *fj_out)
    del fj_out
    times.update(phase_fused_times(torch, wt, fj, timing, joint, fjin, params,
                                   full_case, rates, card))
    del joint, fjin, params, full_case
    # slice 6: the kernels at the backward's two-slice width H=512
    jin512, params512 = wide_inputs(torch, np, carry_flax_joint, FJ_H512,
                                    SEED + 31)
    full512 = fj_full_case(torch, fj, jin512, params512)
    r = fj_cases.compare(fj, *full512, 0)
    torch.cuda.synchronize()
    print(f"fused joint kernels fused slice H=512: {json.dumps(r)}")
    check_deterministic(torch, fj, full512, "H=512")
    h512_times = time_fused_kernels(torch, fj, timing, full512, rates, card,
                                    " H=512")
    del jin512, params512, full512

    # slice 3: the compact layout at cases A and B, rnnt_loss_joint in every
    # layout, the fused joint at LLM-size vocabularies
    from warp_rnnt_tpu_torch.benchmarks import packed_cases as pc
    from warp_rnnt_tpu_torch.functional import joint_loss as jl
    from warp_rnnt_tpu_torch.ops import packed_kernels as pk

    counters = [cuda_impl.LAUNCHES, fk.LAUNCHES, fj.LAUNCHES, pk.LAUNCHES]
    full = {"A": pc.full_case(**CASE_A, seed=SEED),
            "B": pc.full_case(**CASE_B, seed=SEED)}
    errs.update(phase_packed_kernels(
        torch, pk, pc, {f"case {k}": c for k, c in full.items()}))
    compact_launches = {}
    for label, case in full.items():
        compact_launches[label], *out = phase_compact(torch, wt, counters, case,
                                                      f"case {label}")
        check_compact(torch, wt, pk, case, f"case {label}", *out)
        del out
    packed_times, compact_times = {}, {}
    for label, case in full.items():
        packed_times[label] = time_packed_kernels(torch, pk, timing, case, rates,
                                                  card, f"case {label}")
        compact_times[label] = time_compact(
            torch, wt, pk, cuda_impl, timing, case, rates, card,
            f"case {label}", ns)
    times.update(packed_times["A"])
    del full, case

    jparams = carry_flax_joint(fj_tree(np, SEED + 5, JL["F"], JL["H"], JL["V"]),
                               device="cuda")[1]
    jin = joint_inputs(torch, np, JL, SEED + 6)
    route = phase_joint_layouts(torch, wt, jl, fj_cases, counters, jin, jparams)
    time_joint_layouts(torch, wt, timing, jin, jparams,
                       ("padded", "compact", "fused"), card, f"V={JL['V']}")
    print(f"joint auto route on cuda: {route} at V={JL['V']};"
          f" _CUDA_FUSED_MIN_V={jl._CUDA_FUSED_MIN_V}")
    del jin, jparams

    large_errs, large_launches, keep, large_fulls = phase_large_v(
        torch, np, wt, fj, fj_cases, carry_flax_joint, counters)
    check_deterministic(torch, fj, keep[2], "V=64000")
    large_times = time_large_v(torch, wt, fj, timing, keep, rates, card)
    v50257_times = time_fused_kernels(torch, fj, timing, large_fulls["V=50257"],
                                      rates, card, " V=50257")
    del keep, large_fulls
    from warp_rnnt_tpu_torch.benchmarks.profile_loss import profile_step
    route_reads = time_route_sweep(torch, np, wt, timing, profile_step,
                                   carry_flax_joint, card)
    print(f"route sweep readings: {json.dumps(route_reads)}")
    torch.cuda.empty_cache()

    # slice 5: the fused joint at H=200/640/1024/2048 and N=65537, and the
    # kernels' times at H=640 and 1024
    wide_errs, wide_launches, wide_fulls = phase_wide_fused(
        torch, np, wt, fj, fj_cases, carry_flax_joint, counters)
    wide_times = {H: time_fused_kernels(torch, fj, timing, full, rates, card,
                                        f" H={H}")
                  for H, full in wide_fulls.items()}
    del wide_fulls
    torch.cuda.empty_cache()

    # slice 4: the gather experiments' kernels at 2-9 GB, the main path at
    # 7.5 GiB and 9.07 GB; slice 5: the main path's lattice gather among them
    from warp_rnnt_tpu_torch.benchmarks import exp_gather as eg
    from warp_rnnt_tpu_torch.benchmarks import gather_cases as gc
    from warp_rnnt_tpu_torch.benchmarks import profile_loss

    counters.append(gk.LAUNCHES)
    errs.update(phase_gather_kernels(torch, gk, gc, gather_blank_label_plain))
    gather_launches = phase_gather_path(torch, eg, counters)
    gather_times, scatter_times = {}, {}
    for n in GATHER_N:
        gather_times[n] = time_gathers(torch, eg, gk, timing,
                                       gather_blank_label_plain, n, rates, card)
        scatter_times[n] = time_scatter(torch, eg, gk, timing, n, rates, card)
        torch.cuda.empty_cache()
    for n in GATHER_N[1:]:
        phase_big_main(torch, wt, fk, gather_blank_label_plain, timing,
                       counters, n, rates, card)
        torch.cuda.empty_cache()
    big_writes = {}
    for name in fwc.BIG_CASES:  # the N=144 main path's write, past 2^31
        big_writes[name] = fwc.compare_big(fk, name)
        print(f"flat_write {name}: bit for bit against the plain version, 16"
              f" samples at a time; {json.dumps(big_writes[name])}")
        torch.cuda.empty_cache()
    for name in GATHER_PATH[:4]:
        times[name] = gather_times[N][name]
    prof = profile_loss.profile("main")
    print(f"profile main path N={N}: {prof['kernels_per_call']} kernels a call"
          f" (the parent tree: 74), idle share {prof['idle_share']}, device"
          f" busy {prof['busy_ms']} ms, wall {prof['wall_ms']} ms, complete"
          f" {prof['complete']} [{card}]")
    for ms, count, key in prof["rows"]:
        print(f"profile {ms:.4f} ms/call {count} x/call {key[:80]}")
    hold_main_profile(prof)

    # slice 10: the transducer's train step in each loss mode
    (train_launches, train_ms, train_bound, train_errs, train_lattice,
     train_step_ms, train_replay) = phase_train(torch, card, rates)
    print(f"train check errors: {json.dumps(train_errs)}")
    # slice 23: the train step and the compact loss compiled
    compiled_train = phase_compiled_train(torch, card)

    # slice 11: the serving path
    serving_launches, serving_errs, step_entries = phase_serving(
        torch, wt, timing, card)
    compiled_serving = phase_compiled_serving(torch, card)
    # slice 26: a whole decode and a whole chunk compiled
    compiled_decode = phase_compiled_decode(torch, card)

    # slice 12: the parallel tier
    t16 = time.perf_counter()
    parallel_launches, parallel_errs = phase_parallel(
        torch, timing, card, train_step_ms)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    # slice 13: the benchmark tier
    bench_launches, bench_errs, bench_write_ms = phase_benchmarks(torch, card)

    # slice 15: the TensorFlow front end
    tf_launches, tf_errs = phase_tf_binding(torch, card)

    fj_src = "warp_rnnt_tpu/ops/fused_joint.py"
    pk_src = "warp_rnnt_tpu/ops/packed_kernels.py"
    eg_src = "scripts/exp_pallas_gather.py"
    sources = {"lattice_fused": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:134"),
               "lattice_beta_only": ("lattice.cu", "warp_rnnt_tpu/ops/pallas_impl.py:124"),
               "lattice_epilogue": ("lattice.cu",
                                    "warp_rnnt_tpu/functional/postprocess.py:52"
                                    " (costs_and_grads in the XLA fusion of"
                                    " JAX's jit; no TPU kernel)"),
               "flat_write": ("flat_write.cu", "warp_rnnt_tpu/ops/flat_kernels.py:69"
                              f" and {eg_src}:196"),
               "fused_joint_fwd": ("fused_joint.cu", f"{fj_src}:60 and {fj_src}:245"),
               "fused_joint_bwd_dadc": ("fused_joint.cu",
                                        f"{fj_src}:100 and {fj_src}:294"),
               "fused_joint_bwd_dwdb": ("fused_joint.cu",
                                        f"{fj_src}:100 and {fj_src}:356"),
               "packed_gather": ("packed.cu", f"{pk_src}:130 and the stack of"
                                 f" {pk_src}:426"),
               "packed_scatter": ("packed.cu", f"{pk_src}:193"),
               "gather_columns": ("gather.cu", "scripts/exp_colgather.py:117"),
               "gather_fwd": ("gather.cu", f"{eg_src}:63"),
               "gather_fwd_sparse": ("gather.cu", f"{eg_src}:124"),
               "gather_lattice": ("gather.cu",
                                  "warp_rnnt_tpu/functional/gather.py:139"
                                  " (XLA gathers; no TPU kernel)"),
               "fused_joint_hidden": ("fused_joint.cu",
                                      f"{fj_src}:60, {fj_src}:245, {fj_src}:100,"
                                      f" {fj_src}:294 and {fj_src}:356 (h)")}
    # the h image kernel: its numbers at H=1024, launches at H=640
    errs["fused_joint_hidden"] = max(e.get("fused_joint_hidden", 0.0)
                                     for e in wide_errs.values())
    times["fused_joint_hidden"] = wide_times[1024]["fused_joint_hidden"]
    path_launches = {**fj_launches, **compact_launches["A"],
                     **{k: gather_launches[k] for k in GATHER_PATH[:3]},
                     "fused_joint_hidden": wide_launches["fused_joint_hidden"],
                     **launches}

    def base_entry(name, src, replaces):
        return {"name": name, "route": "cuda",
                "source": f"warp_rnnt_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": path_launches[name], "max_abs_err": errs[name],
                "library_ms": None, **times[name]}

    def wide_entries(name):
        return {f"H={H}": {"launches": wide_launches[name],
                           "max_abs_err": wide_errs[H][name], **wt_times[name]}
                for H, wt_times in wide_times.items()}

    kernels = []
    for name, (src, replaces) in sources.items():
        entry = base_entry(name, src, replaces)
        if name in gather_times[N]:
            entry.update({f"N={n}": gather_times[n][name] for n in GATHER_N[1:]})
        if name == "flat_write":
            entry["past_2_31"] = big_writes
            entry["scatter_bwd"] = {
                "launches": gather_launches[name],
                **{f"N={n}": scatter_times[n] for n in GATHER_N}}
        if name.startswith("packed"):
            entry["case_B"] = {"launches": compact_launches["B"][name],
                               **packed_times["B"][name]}
        if name in ("lattice_fused", "lattice_beta_only"):
            for label in ("A", "B"):
                entry[f"case_{label}"] = {
                    "launches": compact_launches[label][name],
                    **compact_times[label]["lattice"][name]}
            entry["case_B"]["max_abs_err"] = errs[f"{name} B"]
        if name.startswith("fused") and name != "fused_joint_hidden":
            entry["V=64000"] = {
                "launches": large_launches[name], **large_times[name],
                "max_abs_err": max(e[name] for e in large_errs.values())}
            entry["V=50257"] = {**v50257_times[name],
                                "max_abs_err": large_errs["V=50257"][name]}
            entry["H=512"] = h512_times[name]
        if name.startswith("fused"):
            entry.update(wide_entries(name))
        if name == "fused_joint_hidden":
            entry["H=512"] = h512_times[name]
        if name in attrs:
            entry["attrs"] = attrs[name]
        train = {mode: train_launches[mode].get(name, 0) for mode in TRAIN_MODES}
        if any(train.values()):
            entry["train"] = {
                "launches": train,
                "device_ms": {mode: train_ms[mode][name] for mode in TRAIN_MODES},
                "bound_ms": train_bound[name][0],
                "bound_by": train_bound[name][1]}
            if name == "lattice_fused":
                entry["train"]["max_abs_err"] = train_lattice
            entry["train"]["launches_a_replay"] = {
                mode: train_replay[mode].get(name, 0) for mode in TRAIN_MODES}
        compact_replay = {label: {call: n.get(name, 0)
                                  for call, n in calls.items()}
                          for label, calls in compiled_train["compact"].items()}
        if any(v for calls in compact_replay.values() for v in calls.values()):
            entry["compiled_compact"] = {"launches_a_call": compact_replay}
        parallel = {call: n[name] for call, n in parallel_launches.items()
                    if name in n}
        if parallel:
            entry["parallel"] = {"launches": parallel}
            if name in parallel_errs:
                entry["parallel"]["max_abs_err"] = parallel_errs[name]
        bench = {call: n[name] for call, n in bench_launches.items()
                 if name in n}
        if bench:
            entry["bench"] = {"launches": bench}
            if name in bench_errs:
                entry["bench"]["max_abs_err"] = bench_errs[name]
            if name == "flat_write":
                entry["bench"]["device_ms"] = bench_write_ms
        tf_calls = {call: n[name] for call, n in tf_launches.items()
                    if name in n}
        if tf_calls:
            entry["tf"] = {"launches": tf_calls,
                           "max_abs_err": {call: tf_errs[call]
                                           for call in tf_calls}}
        if name in SERVING_KERNELS:
            entry["serving"] = {
                "launches": {call: n.get(name, 0)
                             for call, n in serving_launches.items()},
                "max_abs_err": {k: serving_errs[k] for k in (
                    "costs_vs_scan", "no_grad_vs_scan", "grad_vs_scan_share")}}
        joint_replay = {mode: n[name] for mode, n in
                        compiled_serving["joint"].items() if name in n}
        if joint_replay:
            entry["compiled_joint_step"] = {"launches_a_replay": joint_replay}
        kernels.append(entry)
    for entry in step_entries:
        entry["compiled_chunk"] = {"launches": {
            dec: n.get(entry["name"], 0)
            for dec, n in compiled_serving["stream"].items()}}
        entry["compiled_decode"] = {
            "launches": {call: n.get(entry["name"], 0) for call, n in
                         compiled_decode["launches"].items()},
            "launches_a_call": {dec: n.get(entry["name"], 0) for dec, n in
                                compiled_decode["replay"].items()}}
    kernels.extend(step_entries)
    print(f"whole run from the build: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
