"""The plain references against a float64 brute force at tiny sizes."""

import itertools

import torch

from portbench.reference import lattice
from portbench.reference import transducer as ref


def _brute(lp, labels, xn, yn, blank=0):
    """-log of the sum over every alignment of its probability: the yn
    emissions placed among the first xn - 1 + yn moves, the last move the
    final frame's blank."""
    costs = []
    for n in range(lp.shape[0]):
        T, U = int(xn[n]), int(yn[n])
        scores = []
        for emits in itertools.combinations(range(T - 1 + U), U):
            t = u = 0
            s = lp.new_zeros(())
            for move in range(T - 1 + U):
                if move in emits:
                    s = s + lp[n, t, u, labels[n, u]]
                    u += 1
                else:
                    s = s + lp[n, t, u, blank]
                    t += 1
            scores.append(s + lp[n, T - 1, U, blank])
        costs.append(-torch.logsumexp(torch.stack(scores), 0))
    return torch.stack(costs)


def _case(seed=0, N=3, T=5, U=4, V=6):
    g = torch.Generator().manual_seed(seed)
    lp = torch.randn(N, T, U, V, generator=g, dtype=torch.float64)
    lp = lp.log_softmax(-1)
    labels = torch.randint(1, V, (N, U - 1), generator=g, dtype=torch.int32)
    xn = torch.tensor([T, 3, 1][:N], dtype=torch.int32)
    yn = torch.tensor([U - 1, 2, 0][:N], dtype=torch.int32)
    return lp, labels, xn, yn


def test_costs_and_gradients_against_brute_force():
    lp, labels, xn, yn = _case()
    x = lp.clone().requires_grad_(True)
    want = _brute(x, labels, xn, yn)
    want.sum().backward()
    costs, gb, ge = lattice.loss(lp, labels, xn, yn)
    assert torch.allclose(costs, want.detach(), rtol=1e-12, atol=1e-12)
    dense = lattice.dense(gb, ge, labels, lp.shape[-1])
    assert torch.allclose(dense, x.grad, rtol=1e-10, atol=1e-12)
    assert lattice.dense_grad_error(x.grad.float(), labels, gb, ge) < 1e-6


def test_loss_function_backward():
    lp, labels, xn, yn = _case(seed=1)
    x = lp.clone().requires_grad_(True)
    c = lattice.Loss.apply(x, labels, xn, yn, torch.float64, 0)
    (c * torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)).sum().backward()
    y = lp.clone().requires_grad_(True)
    (_brute(y, labels, xn, yn)
     * torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)).sum().backward()
    assert torch.allclose(x.grad, y.grad, rtol=1e-10, atol=1e-12)


def test_lower_precision_reads_apart():
    """The control's precision moves both readings far past float64's."""
    lp, labels, xn, yn = _case(seed=2, N=2, T=40, U=9, V=5)
    xn = torch.tensor([40, 30], dtype=torch.int32)
    yn = torch.tensor([8, 5], dtype=torch.int32)
    c64, gb, ge = lattice.loss(lp, labels, xn, yn)
    c16, gb16, ge16 = lattice.loss(lp, labels, xn, yn, dtype=torch.bfloat16)
    assert float(((c16.double() - c64).abs() / c64).max()) > 1e-3
    grad16 = lattice.dense(gb16, ge16, labels, 5, dtype=torch.float32)
    assert lattice.dense_grad_error(grad16, labels, gb, ge) > 1e-3


def test_dense_grad_error_reads_nan_as_inf():
    lp, labels, xn, yn = _case(seed=3)
    _, gb, ge = lattice.loss(lp, labels, xn, yn)
    grad = lattice.dense(gb, ge, labels, lp.shape[-1], dtype=torch.float32)
    grad[0, 0, 0, 1] = float("nan")
    assert lattice.dense_grad_error(grad, labels, gb, ge) == float("inf")


CFG = {"vocab": 9, "feat_dim": 3, "hidden": 4, "joint": 5, "blocks": 2,
       "kernel": 3, "lr": 1e-2, "weight_decay": 1e-4, "betas": [0.9, 0.999],
       "eps": 1e-8}


def test_transducer_loss_against_brute_force():
    """The plain model's loss is the brute force's mean cost of its own
    fp32 log-softmax, and its gradient reaches every weight."""
    gen = torch.Generator().manual_seed(4)
    w = ref.init_weights(CFG, gen, "cpu")
    feats = torch.randn(2, 4, 3, generator=gen)
    labels = torch.randint(1, 9, (2, 2), generator=gen, dtype=torch.int32)
    xn = torch.tensor([4, 3], dtype=torch.int32)
    yn = torch.tensor([2, 1], dtype=torch.int32)
    batch = (feats, labels, xn, yn)
    got = ref.loss(w, batch, CFG)
    lp = torch.log_softmax(ref.logits(w, feats, labels, CFG), -1).double()
    want = _brute(lp, labels, xn, yn).mean()
    assert abs(float(got) - float(want)) < 1e-5 * float(want)
    losses, first, w1 = ref.train(w, [batch, batch], CFG)
    assert losses[0] == float(got)
    assert set(first) == set(w)
    assert all(not torch.equal(w1[k], w[k]) for k in w)


def test_adamw_matches_torch():
    """One plain AdamW step equals torch's AdamW on the same gradient."""
    gen = torch.Generator().manual_seed(5)
    w = ref.init_weights(CFG, gen, "cpu")
    batch = (torch.randn(2, 4, 3, generator=gen),
             torch.randint(1, 9, (2, 2), generator=gen, dtype=torch.int32),
             torch.tensor([4, 4], dtype=torch.int32),
             torch.tensor([2, 2], dtype=torch.int32))
    tr = ref.Trainer(w, CFG)
    tr.step(batch)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    opt = torch.optim.AdamW(params.values(), lr=CFG["lr"],
                            betas=tuple(CFG["betas"]), eps=CFG["eps"],
                            weight_decay=CFG["weight_decay"])
    for k, p in params.items():
        p.grad = tr.first[k].clone()
    opt.step()
    for k, p in params.items():
        assert torch.allclose(p.detach(), tr.w[k].detach(), rtol=1e-6,
                              atol=1e-7), k


def test_adamw_resumed_from_its_state():
    """A Trainer started from another's weights, moments and step count
    takes the steps that one would have taken."""
    gen = torch.Generator().manual_seed(6)
    w = ref.init_weights(CFG, gen, "cpu")
    batches = [(torch.randn(2, 4, 3, generator=gen),
                torch.randint(1, 9, (2, 2), generator=gen, dtype=torch.int32),
                torch.tensor([4, 3], dtype=torch.int32),
                torch.tensor([2, 1], dtype=torch.int32)) for _ in range(3)]
    whole = ref.Trainer(w, CFG)
    losses = [whole.step(b) for b in batches]
    part = ref.Trainer(w, CFG)
    part.step(batches[0])
    rest = ref.Trainer({k: p.detach() for k, p in part.w.items()}, CFG,
                       moments=(part.m, part.v), t=1)
    assert [rest.step(b) for b in batches[1:]] == losses[1:]
    for k in w:
        assert torch.equal(rest.w[k], whole.w[k]), k
        assert torch.equal(rest.m[k], whole.m[k]), k


def test_beam_search_batched_by_bucket():
    """Two requests of one bucket searched together answer as each searched
    alone: a sample's search is its own."""
    from portbench.reference import beam

    cfg = dict(CFG, hidden=8, joint=6, vocab=12, feat_dim=3)
    gen = torch.Generator().manual_seed(7)
    w = ref.init_weights(cfg, gen, "cpu")
    reqs = [(torch.randn(2, 6, 3, generator=gen),
             torch.tensor([6, n], dtype=torch.int32)) for n in (3, 5)]
    alone = [beam.beam_search(w, f, x, cfg, 3, 5, 2) for f, x in reqs]
    together = beam.beam_search(w, torch.cat([f for f, _ in reqs]),
                                torch.cat([x for _, x in reqs]), cfg, 3, 5, 2)
    for got, want in zip(together, (torch.cat(x) for x in zip(*alone))):
        assert torch.equal(got, want)
