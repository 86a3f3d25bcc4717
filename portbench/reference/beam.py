"""The plain beam search of the transducer, and the best alignment of a
given hypothesis, in plain PyTorch.

`beam_search` is the time-asynchronous batched beam search that the JAX
package and the port run, step for step, written out on the plain model
of `reference.transducer`:

  * every sample carries its own frame pointer t; per step every beam
    proposes its blank (which settles it for the frame) and its top B
    labels (emit: append, advance the predictor, stay active); settled
    beams propose themselves; an exact top-k (argmax rounds, ties to the
    lowest index) keeps B hypotheses;
  * a beam emits at most ``max_symbols`` labels a frame and ``max_length``
    in all;
  * hypotheses with the same prefix (a 32-bit rolling hash), length and
    frame state are merged, the better score surviving;
  * a sample whose live beams have all settled advances t;
  * the loop runs while any sample has frames left.

The decoders' predictor differs from the training path's: the <sos>
step's output is the first row, but its state is dropped, so the labels
run from the zero state (`decode_predictor`).  Scores are best-alignment
log-probs.  `viterbi` gives, for each hypothesis, its best alignment's
log-prob over the whole lattice of its tokens (no cap on emissions a
frame), in float64: a hypothesis' beam score can never exceed it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import lattice
from portbench.reference import transducer as ref

NEG = -1.0e30
HASH_MUL, HASH_MASK = 1000003, 0xFFFFFFFF


def top_k(x, k):
    """Exact top-k over the last axis as k argmax rounds: ties to the
    lowest index, picked entries masked, -inf clamped for the selection."""
    vals, ids = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    sel = x.clamp(min=torch.finfo(x.dtype).min)
    for _ in range(k):
        i = sel.argmax(dim=-1)
        vals.append(x.gather(-1, i[..., None])[..., 0])
        ids.append(i)
        sel = torch.where(iota == i[..., None], -torch.inf, sel)
    return torch.stack(vals, -1), torch.stack(ids, -1)


def _beams(x, parent):
    idx = parent.reshape(parent.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(parent.shape + x.shape[2:]))


def decode_predictor(w, labels, H):
    """(N, U-1) labels -> (N, U, H): the <sos> step's output from the zero
    state, then the states after each label, run from the zero state."""
    N, dev = labels.shape[0], labels.device
    zero = torch.zeros(N, H, device=dev)
    outs, h = [ref.gru_cell(w, zero, zero, H)], zero
    emb = F.embedding(labels.long(), w["predictor.embed.weight"])
    for u in range(labels.shape[1]):
        h = ref.gru_cell(w, emb[:, u], h, H)
        outs.append(h)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def beam_search(w, feats, xn, cfg, beam: int, max_length: int,
                max_symbols: int, blank: int = 0, quant=None):
    """(tokens (N, max_length), lengths (N,), scores (N,)) of the best
    hypothesis of each utterance."""
    enc = ref.encoder(w, feats, cfg, quant)
    N, T, H = enc.shape
    B, L, dev = beam, max_length, enc.device
    K = min(B, cfg["vocab"] - 1)
    xn = xn.long()
    t = torch.zeros(N, dtype=torch.long, device=dev)
    scores = torch.full((N, B), NEG, device=dev)
    scores[:, 0] = 0.0
    tokens = torch.full((N, B, L), blank, dtype=torch.long, device=dev)
    u = torch.zeros((N, B), dtype=torch.long, device=dev)
    nexp = torch.zeros_like(u)
    waiting = torch.zeros((N, B), dtype=torch.bool, device=dev)
    hcode = torch.zeros_like(u)
    h = torch.zeros(N * B, H, device=dev)
    out = ref.gru_cell(w, h, h, H)
    l_iota = torch.arange(L, device=dev)[None, None, :]
    i_iota = torch.arange(B, device=dev)[None, :, None]
    j_iota = torch.arange(B, device=dev)[None, None, :]
    rows = torch.arange(N, device=dev)[:, None] * B
    for _ in range(T * (max_symbols + 1)):
        if not bool((t < xn).any()):
            break
        f = enc[torch.arange(N, device=dev), t.clamp(0, T - 1)]
        logp = torch.log_softmax(ref.joint(
            w, f.repeat_interleave(B, 0)[:, None], out[:, None],
            quant)[:, 0, 0], dim=-1)
        lp_blank = logp[:, blank].reshape(N, B)
        lab = logp.clone()
        lab[:, blank] = NEG
        top_lp, top_ids = top_k(lab, K)
        top_lp, top_ids = top_lp.reshape(N, B, K), top_ids.reshape(N, B, K)

        frame_on = (t < xn)[:, None]
        alive = scores > 0.5 * NEG
        expandable = (frame_on & alive & ~waiting & (u < L)
                      & (nexp < max_symbols))
        settle = torch.where(frame_on & ~waiting, scores + lp_blank, scores)
        lab_scores = torch.where(expandable[..., None],
                                 scores[..., None] + top_lp,
                                 torch.full_like(top_lp, NEG))
        cand = torch.cat([settle[..., None], lab_scores], -1)
        new_scores, sel = top_k(cand.reshape(N, B * (K + 1)), B)
        parent, kind = sel // (K + 1), sel % (K + 1)
        tokens, u = _beams(tokens, parent), _beams(u, parent)
        nexp, hcode = _beams(nexp, parent), _beams(hcode, parent)
        scores = new_scores
        emit = kind > 0
        new_tok = _beams(top_ids, parent).gather(
            2, (kind - 1).clamp(min=0)[..., None])[..., 0]
        tokens = torch.where(emit[..., None] & (l_iota == u[..., None]),
                             new_tok[..., None], tokens)
        u = torch.where(emit, u + 1, u)
        nexp = torch.where(emit, nexp + 1, nexp)
        hcode = torch.where(emit, (hcode * HASH_MUL + new_tok + 1)
                            & HASH_MASK, hcode)
        waiting = frame_on & ~emit
        same = ((hcode[:, :, None] == hcode[:, None, :])
                & (u[:, :, None] == u[:, None, :])
                & (waiting[:, :, None] == waiting[:, None, :]))
        s_i, s_j = scores[:, :, None], scores[:, None, :]
        beats = (s_i > s_j) | ((s_i == s_j) & (i_iota < j_iota))
        killed = (same & beats & (i_iota != j_iota)).any(dim=1)
        scores = torch.where(killed, torch.full_like(scores, NEG), scores)
        active = ~waiting & (scores > 0.5 * NEG)
        advance = (t < xn) & ~active.any(dim=1)
        t = torch.where(advance, t + 1, t)
        waiting = waiting & ~advance[:, None]
        nexp = torch.where(advance[:, None], torch.zeros_like(nexp), nexp)

        src = (rows + parent).reshape(-1)
        h_src, out_src = h[src], out[src]
        tok = new_tok.reshape(-1)
        emb = F.embedding(tok, w["predictor.embed.weight"])
        new = ref.gru_cell(w, emb, h_src, H)
        e = emit.reshape(-1, 1)
        h = torch.where(e, new, h_src)
        out = torch.where(e, new, out_src)
    best = scores.argmax(dim=1)
    n = torch.arange(N, device=dev)
    return tokens[n, best], u[n, best], scores[n, best]


@torch.no_grad()
def viterbi(w, feats, xn, tokens, lengths, cfg, block: int = 4):
    """(N,) float64: each hypothesis' best alignment log-prob, the final
    frame's blank included, over the lattice of its own tokens."""
    N = feats.shape[0]
    U = int(lengths.max()) + 1
    enc = ref.encoder(w, feats, cfg)
    out = []
    for i in range(0, N, block):
        sl = slice(i, i + block)
        labels = tokens[sl, :U - 1].contiguous()
        g = decode_predictor(w, labels, cfg["hidden"])
        lp = torch.log_softmax(ref.joint(w, enc[sl], g), -1)
        b, e = lattice.gather(lp, labels)
        del lp
        out.append(lattice.best_path(b, e, xn[sl], lengths[sl]))
    return torch.cat(out)
