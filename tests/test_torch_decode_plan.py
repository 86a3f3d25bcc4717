"""The decode step's launch plans (`warp_rnnt_tpu_torch/ops/decode_step.py`
`dense_plan`, `gru_plan`), on the CPU: the plan is Python the CPU reaches,
the kernels that read it run on the card only.

  * At every width the step meets (bench width: greedy 32 rows, beam 128,
    F = H = 512, V = 1024; streaming, N = 8; the odd widths of
    `decode_step_cases.ODD`; a wide model, hidden 1024 and V = 5000 at 16
    and 64 rows; `decode_step_cases.RING`'s), in bf16 and fp32, add and
    concat: dynamic shared memory within what a Hopper block can use
    (232,448 bytes, less the kernels' static arrays), a cluster of at
    most 8 blocks (a power of two) that divides the grid, K shares that
    cover K exactly once, chunks that cover a share, and a ring of stages
    exactly where the whole share does not fit.
  * The entries still run their plain versions on CPU tensors: equal to
    the plain functions bit for bit, and to JAX's `Transducer.joint_step`
    and `predictor_step` on a carried tree as before.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import carried_pair
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.models import decoding
from warp_rnnt_tpu_torch.ops import decode_step as ds

BUDGET = ds.SMEM_MAX - ds.STATIC_SMEM

# (rows, hidden H, vocabulary V, input width F (= F'), GRU width)
WIDTHS = {
    "bench greedy": (32, 512, 1024, 512, 512),
    "bench beam": (128, 512, 1024, 512, 512),
    "stream greedy": (8, 512, 1024, 512, 512),
    "stream beam": (32, 512, 1024, 512, 512),
    **{f"odd rows={r}": (r, dsc.ODD["H"], dsc.ODD["V"], dsc.ODD["Hp"],
                         dsc.ODD["Hp"]) for r, _, _ in dsc.ODD_ROWS},
    **{f"wide rows={r}": (r, dsc.WIDE["H"], dsc.WIDE["V"], dsc.WIDE["Hp"],
                          dsc.WIDE["Hp"]) for r, _, _ in dsc.WIDE_ROWS},
    **{f"ring rows={r}": (r, dsc.RING["H"], dsc.RING["V"], dsc.RING["Hp"],
                          dsc.RING["Hg"]) for r, _, _ in dsc.RING_ROWS},
}


def _hold_split(plan, K):
    """The cluster's K shares cover [0, K) exactly once, each rank's
    non-empty; the chunks cover a share; a ring exactly where a share
    does not fit at once."""
    cluster, share = plan["cluster"], plan["k_share"]
    assert 1 <= cluster <= ds.CLUSTER_MAX and cluster & (cluster - 1) == 0
    assert share % ds.K_STEP == 0 and plan["chunk"] % ds.K_STEP == 0
    covered = []
    for rank in range(cluster):
        lo, hi = rank * share, min((rank + 1) * share, K)
        assert lo < hi, (rank, plan)
        covered.extend(range(lo, hi))
    assert covered == list(range(K))
    chunks = -(-share // plan["chunk"])
    assert 1 <= plan["stages"] <= min(ds.RING_STAGES, chunks)
    assert (plan["stages"] > 1) == (chunks > 1)
    assert plan["smem"] + ds.STATIC_SMEM <= ds.SMEM_MAX
    assert plan["grid"][0] % cluster == 0


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["add", "concat"])
def test_dense_plans_hold(width, elem, mode):
    rows, H, V, Fw, _ = WIDTHS[width]
    concat = mode == "concat"
    K = 2 * Fw if concat else Fw
    for first, k_in, cols in ((True, K, H), (False, H, V)):
        plan = ds.dense_plan(rows, k_in, cols, elem, first, concat and first)
        _hold_split(plan, k_in)
        assert plan["smem"] == ds.dense_smem(elem, first, concat and first,
                                             plan["chunk"], plan["stages"])
        whole = ds.dense_smem(elem, first, concat and first,
                              plan["k_share"], 1)
        assert (plan["stages"] > 1) == (whole > BUDGET)
        assert plan["grid"] == (plan["cluster"] * -(-cols // ds.COL_TILE),
                                -(-rows // ds.ROW_TILE))
        assert plan["threads"] == ds.THREADS


@pytest.mark.parametrize("width", list(WIDTHS))
def test_gru_plans_hold(width):
    rows, _, _, _, Hg = WIDTHS[width]
    plan = ds.gru_plan(rows, Hg)
    _hold_split(plan, Hg)
    mt, kg = plan["row_tile"], plan["k_groups"]
    assert mt in (16, 32, 64) and mt >= min(rows, 64)
    assert (mt // 4) * (ds.GRU_UNITS // 4) * kg == plan["threads"] == ds.THREADS
    assert plan["chunk"] % ds.GRU_BOX == 0 and plan["k_share"] % ds.GRU_BOX == 0
    assert plan["chunk"] % (4 * kg) == 0
    assert plan["smem"] == ds.gru_smem(mt, plan["chunk"], plan["stages"], kg)
    whole = ds.gru_smem(mt, plan["k_share"], 1, kg)
    assert (plan["stages"] > 1) == (whole > ds.GRU_SMEM)
    assert plan["smem"] <= ds.GRU_SMEM
    assert plan["grid"] == (plan["cluster"] * -(-Hg // ds.GRU_UNITS),
                            -(-rows // mt))


def test_ring_widths_take_a_ring_and_bench_widths_do_not():
    for name, (rows, H, V, Fw, Hg) in WIDTHS.items():
        if name.startswith("wide"):
            continue
        hidden = ds.dense_plan(rows, Fw, H, 2, True, False)
        ring = name.startswith("ring")
        assert (hidden["stages"] > 1) == ring, name
        if ring:
            assert ds.gru_plan(rows, Hg)["stages"] > 1, name
    # greedy's GRU at bench width: its whole share at once
    assert ds.gru_plan(32, 512)["stages"] == 1
    # bench width: one trip for each share, K split over a cluster, every
    # block of a launch at once
    for rows in (32, 128):
        for plan, most in ((ds.dense_plan(rows, 512, 512, 2, True, False),
                            ds.DENSE_BLOCKS),
                           (ds.dense_plan(rows, 512, 1024, 2, False),
                            ds.DENSE_BLOCKS),
                           (ds.gru_plan(rows, 512), ds.GRU_BLOCKS)):
            assert plan["grid"][0] * plan["grid"][1] <= most
            assert plan["grid"][0] * plan["grid"][1] * 2 > most or (
                plan["cluster"] == ds.CLUSTER_MAX)
    assert ds.dense_plan(32, 512, 512, 2, True, False)["cluster"] == 8


def test_plan_refuses_what_no_ring_fits():
    with pytest.raises(ValueError, match="no ring"):
        ds._ring(4096, lambda chunk, stages: 10 ** 9)


# ---- the entries on CPU tensors: their plain versions, as before ----

N, T, F, V, H, B = 4, 23, 9, 21, 24, 3


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def carried(request):
    feats = np.random.RandomState(0).randn(N, T, F).astype(np.float32)
    model, params, port = carried_pair(request.param, 2, feats, V, H)
    return request.param, model.bind(params), port


def _rows(seed, rows, width, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(rows, width)
            ).astype(np.float32)


@pytest.mark.parametrize("per_sample", [1, B])
def test_joint_entry_on_cpu_is_plain_and_matches_jax(carried, per_sample):
    variant, bound, port = carried
    rows = N * per_sample
    f, g = _rows(51, N, H), _rows(52, rows, H, 0.5)
    dc = decoding.decode_consts(port)
    enc = torch.tensor(f)[:, None]
    t, p0 = torch.zeros(N, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)
    args = (enc, t, p0, torch.tensor(g), *dc.tensors[:4], dc.mode, 0)
    got_lp, want_lp = torch.empty((rows, V)), torch.empty((rows, V))
    with torch.inference_mode():
        got = ds.decode_joint(*args, None, got_lp)
        want = ds.decode_joint_plain(*args, None, want_lp)
        beam = ds.decode_joint(*args, B)
        beam_want = ds.decode_joint_plain(*args, B)
    assert torch.equal(got, want) and torch.equal(got_lp, want_lp)
    assert all(torch.equal(a, b) for a, b in zip(beam, beam_want))
    jax_lp = np.asarray(bound.joint_step(
        jnp.asarray(np.repeat(f, per_sample, axis=0)), jnp.asarray(g)))
    if variant == "fp32":
        np.testing.assert_allclose(got_lp.numpy(), jax_lp, rtol=0, atol=1e-5)
    else:
        logits = np.asarray(bound.joint(
            jnp.asarray(np.repeat(f, per_sample, axis=0))[:, None],
            jnp.asarray(g)[:, None], normalize=False))[:, 0, 0]
        tol = dsc.logp_tol(torch.tensor(logits), torch.bfloat16).numpy()
        assert (np.abs(got_lp.numpy() - jax_lp) <= tol).all()


def test_gru_entries_on_cpu_are_plain_and_match_jax(carried):
    _, bound, port = carried
    rng = np.random.RandomState(61)
    rows = 2 * N
    h = torch.tensor(_rows(62, rows, H, 0.5))
    out = torch.tensor(_rows(63, rows, H))
    token = torch.tensor(rng.randint(-1, V, rows).astype(np.int32))
    emit = torch.tensor(rng.randint(0, 2, rows).astype(bool))
    emit[0] = True
    src = torch.tensor(rng.randint(0, rows, rows).astype(np.int32))
    gru = (*decoding.gru_params(port), port.predictor.recurrent_bias())
    with torch.inference_mode():
        for kw in ({}, {"src": src}):
            got = ds.decode_gru(token, h, out, emit, *gru, **kw)
            want = ds.decode_gru_plain(token, h, out, emit, *gru, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        got = ds.decode_gru(token, h, out, emit, *gru)
    ref, _ = bound.predictor_step(jnp.asarray(h.numpy()),
                                  jnp.asarray(token.numpy()))
    e = emit.numpy()
    np.testing.assert_allclose(got[0].numpy()[e], np.asarray(ref)[e], rtol=0,
                               atol=1e-5)
    assert torch.equal(got[0][~emit], h[~emit])
