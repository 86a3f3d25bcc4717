"""The compiled beam decode of the port's `Transducer`:
`models.beam_search.compiled_beam_decode`, the whole decode (encoder, the
device loop of beam steps, the best hypothesis) one CUDA graph a shape,
one client in a closed loop.  A request is ``N`` utterances padded to a
bucket of frames (`traffic.requests`); its latency runs from the call to
its tokens, lengths and scores on the host.  Set-up captures the graph of
every bucket the mix asks for.  In a traced run a CUDA event pair is
recorded on the stream around every graph replay (`_ReplaySpans`): the
device's span of a request, without the host's work before the replay
and its read after it.

Check, on every request of the pool answered in the window (each answered
the same on every repeat: exact), against the plain reference
(`reference.beam`) from the same weights:
``token_mismatch_share``: the share of utterances whose tokens or length
differ from the reference's own beam search at the configuration's
precision; a near-tie that the two sides' bf16 roundings break apart
sends an utterance down another path now and then, so the limit is a
share.  ``score_gap_mean``: the mean over utterances of |the program's
score - the reference search's| / |the reference's score|: a search in
another precision, a decoder that stops emitting, or scores given to
other utterances read above it.  (The reference's score less the best
alignment of the program's hypothesis is no measure of a worse search
here: under random weights the empty hypothesis, a blank a frame,
outscores what any beam search finds, since a beam emits wherever its
best label beats the blank of that step.)  ``score_excess``: the largest
(program's score - its tokens' best alignment) / |best alignment|: a
beam score can never lie above its hypothesis' best alignment (float64
over the lattice of its own tokens), so this catches a score altered or
given to another utterance.  ``format_errors``: utterances whose length exceeds the
bound, or whose tokens are blank inside their length or not blank past
it.  ``repeat_mismatches``: repeats of a request that answered otherwise
than its first.  The control is the reference's beam search with the
inputs of its bf16 products rounded through float8.
"""

from __future__ import annotations

import time

import torch

from portbench import traffic
from portbench.reference import beam
from portbench.reference import transducer as ref


def port_call(config, model):
    from warp_rnnt_tpu_torch.models.beam_search import compiled_beam_decode

    c = config

    def call(feats, xn):
        out = compiled_beam_decode(model, feats, xn, c["max_length"],
                                   c["beam"], c["max_symbols_per_step"])
        return tuple(x.cpu() for x in out)

    return call


def control(config):
    """The control: the reference beam search in the program's place, the
    inputs of its bf16 products rounded through float8."""
    def wrap(call):
        cell = call.cell

        def f(feats, xn):
            out = beam.beam_search(cell.w0, feats, xn, config, config["beam"],
                                   config["max_length"],
                                   config["max_symbols_per_step"],
                                   quant=ref.fp8)
            return tuple(x.cpu() for x in out)
        return f
    return wrap


def _half_batch(call):
    """Half of the batch left out: the first half decoded, its answers
    repeated for the rest."""
    def f(feats, xn):
        h = feats.shape[0] // 2
        return call(torch.cat([feats[:h], feats[:h]]),
                    torch.cat([xn[:h], xn[:h]]))
    return f


def _token_altered(call):
    """A token altered where it is produced: the first token of the first
    utterance that emitted one, moved to the next label."""
    V = call.cell.config["vocab"]

    def f(feats, xn):
        tokens, lengths, scores = call(feats, xn)
        tokens = tokens.clone()
        n = int((lengths > 0).nonzero()[0, 0])
        tokens[n, 0] = tokens[n, 0] % (V - 1) + 1
        return tokens, lengths, scores
    return f


def _all_blank(call):
    """A decoder that emits nothing: every hypothesis empty, each scored by
    its one alignment (a blank a frame), so that scores and tokens agree."""
    cell = call.cell

    def f(feats, xn):
        tokens, lengths, _ = call(feats, xn)
        tokens, lengths = torch.zeros_like(tokens), torch.zeros_like(lengths)
        scores = beam.viterbi(cell.w0, feats, xn, tokens.to(feats.device),
                              lengths.to(feats.device), cell.config)
        return tokens, lengths, scores.float().cpu()
    return f


FAULTS = {"half_batch": _half_batch, "token_altered": _token_altered,
          "all_blank": _all_blank}


class _ReplaySpans:
    """CUDA events recorded on the stream just before and just after every
    `torch.cuda.CUDAGraph` replay while installed: the device's span of
    each replay, the host's work around it left out."""

    def __init__(self):
        self.spans = []
        self.replay = None

    def install(self):
        cls = torch.cuda.CUDAGraph
        self.replay = replay = cls.replay
        spans = self.spans

        def timed(graph):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            replay(graph)
            end.record()
            spans.append((start, end))
        cls.replay = timed

    def remove(self):
        if self.replay is not None:
            torch.cuda.CUDAGraph.replay = self.replay
            self.replay = None


class Cell:
    def __init__(self, config, mix, seed, device, wrap=None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.wrap = wrap
        self.units = int(mix["N"])
        self.limits = mix["limits"]
        self.traced = False

    def setup(self):
        from warp_rnnt_tpu_torch.models.transducer import Transducer

        c = self.config
        t0 = time.time()
        gen = traffic.generator(self.seed, self.device)
        self.w0 = ref.init_weights(c, gen, self.device)
        self.requests = traffic.requests(self.mix, gen, self.device)
        self.model = Transducer(c["vocab"], c["hidden"], c["hidden"],
                                c["joint"], c["joint_mode"], c["feat_dim"],
                                torch.bfloat16, device=self.device)
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.w0[k])
        self.model.eval()
        call = port_call(c, self.model)
        call.cell = self
        self.program = self.wrap(call) if self.wrap else call
        self.outputs, self.timer = [], None
        t1 = time.time()
        seen = set()
        for i, r in enumerate(self.requests):  # each bucket's capture, twice
            if r["feats"].shape[1] not in seen:
                seen.add(r["feats"].shape[1])
                self.call(i)
                self.call(i)
        self.outputs = []
        self.phases = {"inputs and model": t1 - t0,
                       "captures": time.time() - t1}

    def call(self, i):
        if self.traced and self.timer is None:
            self.timer = _ReplaySpans()
            self.timer.install()
        b = i % len(self.requests)
        r = self.requests[b]
        self.outputs.append((b, self.program(r["feats"], r["xn"])))

    def finish(self):
        if self.device == "cuda":
            torch.cuda.synchronize()
        if self.timer is not None:
            self.timer.remove()

    def context(self):
        spans = [s.elapsed_time(e) / 1e3 for s, e in self.timer.spans] \
            if self.timer is not None else []
        return {"N": self.mix["N"], "calls": len(self.outputs),
                "spans_s": spans}

    def check(self):
        c, lim = self.config, self.limits
        first, mismatches = {}, 0
        for b, out in self.outputs:
            if b not in first:
                first[b] = out
            elif not all(torch.equal(x, y) for x, y in zip(out, first[b])):
                mismatches += 1
        del self.model, self.program
        if self.device == "cuda":
            torch.cuda.empty_cache()
        L = c["max_length"]
        searched = _searched(self.w0, [self.requests[b] for b in first], c)
        excess, gaps, fmt, differ, total = [], [], 0, 0, 0
        for b, (ref_tok, ref_len, ref_score) in zip(first, searched):
            r = self.requests[b]
            tokens, lengths, scores = (x.to(self.device) for x in first[b])
            pos = torch.arange(tokens.shape[1], device=self.device)[None]
            inside = pos < lengths[:, None].long()
            fmt += int(((lengths > L) | ((tokens == 0) & inside).any(1)
                        | ((tokens != 0) & ~inside).any(1)).sum())
            best = beam.viterbi(self.w0, r["feats"], r["xn"], tokens,
                                lengths.clamp(0, L), c, block=16)
            excess.append(((scores.double() - best) / best.abs()).max())
            ref_score = ref_score.double()
            gaps.append((scores.double() - ref_score).abs() / ref_score.abs())
            differ += int(((ref_len != lengths.long())
                           | (ref_tok != tokens.long()).any(1)).sum())
            total += tokens.shape[0]
        inf = float("inf")
        excess = float(torch.stack(excess).max().nan_to_num(inf))
        gap = float(torch.cat(gaps).mean().nan_to_num(inf))
        share = differ / total
        failed = mismatches + fmt + int(excess > lim["score_excess"])
        return ({"token_mismatch_share": (share,
                                          lim["token_mismatch_share"]),
                 "score_gap_mean": (gap, lim["score_gap_mean"]),
                 "score_excess": (excess, lim["score_excess"]),
                 "format_errors": (fmt, 0),
                 "repeat_mismatches": (mismatches, 0)}, failed)


def _searched(w, requests, c):
    """The reference's beam search of each request: [(tokens, lengths,
    scores)], the requests of one bucket searched together (each sample's
    search is its own; one search a bucket takes a third of the steps)."""
    buckets = {}
    for i, r in enumerate(requests):
        buckets.setdefault(r["feats"].shape[1], []).append(i)
    out = [None] * len(requests)
    for idx in buckets.values():
        feats = torch.cat([requests[i]["feats"] for i in idx])
        xn = torch.cat([requests[i]["xn"] for i in idx])
        found = beam.beam_search(w, feats, xn, c, c["beam"], c["max_length"],
                                 c["max_symbols_per_step"])
        for j, i in enumerate(idx):
            n = requests[i]["feats"].shape[0]
            out[i] = tuple(x[j * n:(j + 1) * n] for x in found)
    return out
