"""Beam's selection as one warp a sample (`ops/decode_step.py`
`select_plan`) and the device loop's round ended by one launch
(`utils/device_loop.py`: a folded loop whose cond is an `AnyLess`), on the
CPU, where the wrappers run their plain versions and the while node runs
as its plain version (`device_loop._host_node`: `_card_round` then
`_continue_plain`, one read a loop).

  * `select_plan` at every (B, K) of `decode_step_cases.SELECT_WIDTHS` and
    at the `MAX_K` edges: the fewest register slots that hold the B (K + 1)
    candidates, shared memory past 128, the token rows staged where they
    fit, the warps a block and the shared bytes as the kernel recomputes
    them.
  * The ``into=`` route of `decode_gru_plain`, `decode_gru_greedy_plain`
    and `decode_beam_select_plain` (and their wrappers) writes their fresh
    outputs bit for bit and returns the given tensors; an ``into`` that
    overlaps an input, or has another shape, raises.
  * The folded drains on the card's route (`_host_node`) against the eager
    loop (`_round` + `_continues`) and JAX's ``greedy_drain`` and
    ``beam_drain`` at unroll 1 (the last step is also the first: the copy
    route), 3, 16 and 64: the whole state bit for bit, JAX's trip count,
    one read, and as many rounds as the eager loop's reads.
  * The folded toy on the card's cond against ``lax.while_loop``;
    `_continue_plain` against the stop rule; which loops the card takes
    the cond of; the round fit's arithmetic; and the card checks' code
    (`select_width_cases`, `check_select_twice`) with both sides plain.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode_fold import _bits_equal, _counter, _drain, drains  # noqa: F401
from test_torch_device_loop import _assert_state_matches
from warp_rnnt_tpu_torch.benchmarks import decode_step_cases as dsc
from warp_rnnt_tpu_torch.benchmarks import device_loop_cases as dlc
from warp_rnnt_tpu_torch.models import decoding
from warp_rnnt_tpu_torch.ops import decode_step as ds
from warp_rnnt_tpu_torch.utils import device_loop

UNROLLS = (1, 3, 16, 64)
EDGES = ((1, 64), (64, 1), (63, 63), (64, 64), (2, 63), (31, 1), (32, 3))


# ---- the selection's launch plan ----

def _check_plan(N, B, K, L):
    p = ds.select_plan(N, B, K, L)
    nc = B * (K + 1)
    fits = [s for s in ds.SELECT_SLOTS if 32 * s >= nc]
    assert p["slots"] == (fits[0] if fits else 0)
    assert p["route"] == ("registers" if p["slots"] else "shared")
    tok = -(-4 * B * L // 16) * 16 if p["stage"] else 0
    cand = 0 if p["slots"] else -(-12 * nc // 16) * 16
    assert (p["tok_bytes"], p["warp_bytes"]) == (tok, tok + cand)
    assert (tok, tok + cand) == ds.select_smem(B, K, L, p["slots"],
                                               p["stage"])
    assert 1 <= p["warps"] <= min(ds.SELECT_WARPS, N)
    assert p["smem"] == p["warps"] * p["warp_bytes"] <= ds.SELECT_SMEM
    assert p["threads"] == 32 * p["warps"]
    assert p["grid"] == math.ceil(N / p["warps"])
    if p["smem"] and p["warps"] < min(ds.SELECT_WARPS, N):
        assert (p["warps"] + 1) * p["warp_bytes"] > ds.SELECT_SMEM
    # the rows are staged wherever a warp's share with them fits
    with_rows = -(-4 * B * L // 16) * 16 + cand
    assert p["stage"] == int(with_rows <= ds.SELECT_SMEM)
    return p


@pytest.mark.parametrize("B,K", dsc.SELECT_WIDTHS)
def test_select_plan_at_the_card_widths(B, K):
    p = _check_plan(9, B, K, dsc.SELECT_WIDTH_DIMS["L"])
    assert p["stage"] == 1
    assert p["route"] == ("registers" if B * (K + 1) <= 128 else "shared")


@pytest.mark.parametrize("B,K", EDGES)
@pytest.mark.parametrize("N,L", [(1, 1), (32, 100), (200, 1001)])
def test_select_plan_at_the_max_k_edges(B, K, N, L):
    p = _check_plan(N, B, K, L)
    if B * (K + 1) > 128:
        assert p["slots"] == 0


def test_select_plan_bench_width_and_the_rows_read_in_place():
    p = ds.select_plan(32, 4, 4, 100)  # bench_decode's beam 4
    assert (p["route"], p["slots"], p["stage"], p["warps"], p["grid"],
            p["smem"]) == ("registers", 1, 1, 4, 8, 4 * 1600)
    big = ds.select_plan(4, 64, 64, 1000)  # 256 KB of rows a sample
    assert big["stage"] == 0 and big["tok_bytes"] == 0
    assert big["smem"] == big["warps"] * -(-12 * 64 * 65 // 16) * 16


# ---- the into= route ----

def _gru_params(seed, vocab=11, H=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(vocab, H, generator=g),
            torch.randn(3 * H, H, generator=g) / 3,
            torch.randn(3 * H, H, generator=g) / 3,
            torch.randn(3 * H, generator=g), torch.randn(3 * H, generator=g))


def _fresh_like(xs):
    return tuple(torch.full_like(x, 7) for x in xs)


@pytest.mark.parametrize("src", [False, True])
def test_gru_into_equals_fresh(src):
    rows, H = 6, 8
    g = torch.Generator().manual_seed(1)
    h, out = torch.randn(rows, H, generator=g), torch.randn(rows, H, generator=g)
    token = torch.tensor([-1, 0, 3, 10, 2, 5], dtype=torch.int32)
    emit = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool)
    m = (torch.tensor([5, 4, 3, 2, 1, 0], dtype=torch.int32),) if src else ()
    args = (token, h, out, emit, *_gru_params(2))
    want = ds.decode_gru_plain(*args, *m)
    for fn in (ds.decode_gru_plain, ds.decode_gru):
        into = _fresh_like(want)
        got = fn(*args, *m, into=into)
        assert all(a is b for a, b in zip(got, into))
        _bits_equal(got, want)


@pytest.mark.parametrize("fold", [None, True, False])
def test_greedy_gru_into_equals_fresh(fold):
    args = dsc.odd_args(3, 5, 5, None, torch.float32, device="cpu")[2]
    if fold is not None:
        args = dsc.fold_args("decode_gru_greedy", args, fold)
    want = ds.decode_gru_greedy_plain(*args)
    for fn in (ds.decode_gru_greedy_plain, ds.decode_gru_greedy):
        into = _fresh_like(want)
        got = fn(*args, into=into)
        assert all(a is b for a, b in zip(got, into))
        _bits_equal(got, want)


@pytest.mark.parametrize("fold", [None, True, False])
@pytest.mark.parametrize("B", dsc.SELECT_BEAMS)
def test_select_into_equals_fresh(B, fold):
    args = dsc.select_state(B, B, "cpu")
    if fold is not None:
        args = dsc.fold_args("decode_beam_select", args, fold)
    want = ds.decode_beam_select_plain(*args)
    n = 7 if fold is None else 8
    for fn in (ds.decode_beam_select_plain, ds.decode_beam_select):
        into = _fresh_like((*want[:7], *want[10:]))
        got = fn(*args, into=into)
        assert len(into) == n
        assert all(a is b for a, b in zip((*got[:7], *got[10:]), into))
        _bits_equal(got, want)


def test_into_that_overlaps_an_input_or_misfits_raises():
    args = dsc.select_state(1, 4, "cpu")
    state = args[:7]
    with pytest.raises(ValueError, match="overlaps"):
        ds.decode_beam_select(*args, into=(*state[:2], state[2][:, :, 1:]
                                           .contiguous(), *state[3:]))
    with pytest.raises(ValueError, match="overlaps"):
        ds.decode_beam_select(*args, into=tuple(state))
    with pytest.raises(ValueError, match="into's tokens"):
        ds.decode_beam_select(*args, into=(*_fresh_like(state[:2]),
                                           state[2][:, :1].clone(),
                                           *_fresh_like(state[3:])))
    with pytest.raises(ValueError, match="holds 7 tensors, not 8"):
        ds.decode_beam_select(*dsc.fold_args("decode_beam_select", args,
                                             True),
                              into=_fresh_like(state))
    g = dsc.odd_args(3, 5, 5, None, torch.float32, device="cpu")[2]
    with pytest.raises(ValueError, match="overlaps"):
        ds.decode_gru_greedy(*g, into=(*_fresh_like(g[1:4]), g[5],
                                       *_fresh_like(g[6:8])))


# ---- the card's route, in plain torch ----

@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("name", ["greedy", "beam1", "beam4"])
def test_card_route_drain_matches_eager_and_jax(drains, name, unroll):
    port, enc, want = drains
    state, trips = want[name]
    c = _counter(name)
    decoding.LOOP_ITERATIONS[c] = decoding.HOST_READS[c] = 0
    with device_loop.unrolled(unroll):
        eager = _drain(port, enc, name)
        reads = decoding.HOST_READS[c]
        decoding.LOOP_ITERATIONS[c] = decoding.HOST_READS[c] = 0
        with device_loop._host_node() as rounds:
            got = _drain(port, enc, name)
    _bits_equal(got, eager)
    _assert_state_matches(got, state)
    assert decoding.LOOP_ITERATIONS[c] == trips
    assert decoding.HOST_READS[c] == 1
    assert rounds == [reads] == [max(1, math.ceil(trips / unroll))]


@pytest.mark.parametrize("name", ["greedy", "beam4"])
def test_unroll_one_copies_and_surplus_rounds_keep_the_state(drains, name):
    port, enc, _ = drains
    with device_loop.unrolled(1), device_loop._host_node():
        done = _drain(port, enc, name)
        # a finished state: one masked round, through the copy route
        again = _drain(port, enc, name, done)
    _bits_equal(again, done)
    with device_loop.unrolled(1):
        _bits_equal(done, _drain(port, enc, name))


def test_card_round_writes_the_static_buffers_past_unroll_one():
    cond, body = dlc._frames_toy()
    lim = torch.tensor([0, 3, 7, 10], dtype=torch.int32)
    for unroll in (1, 4):
        static = dlc._toy_state([0, 3, 7, 10], "cpu")[:2]
        count = torch.zeros((), dtype=torch.int32)
        ptrs = [x.data_ptr() for x in (*static, count)]
        seen = []

        def spy(state, consts, count, into=None):
            seen.append(into is not None)
            return body(state, consts, count, into=into)

        device_loop._card_round(spy, static, (lim,), count, unroll, static,
                                count)
        assert seen == [False] * (unroll - 1) + [unroll > 1]
        assert [x.data_ptr() for x in (*static, count)] == ptrs
        assert int(count) == unroll and static[0].tolist() == [
            0, min(3, unroll), min(7, unroll), min(10, unroll)]


def test_frames_toy_on_the_card_route_matches_jax():
    lim = np.array([0, 3, 7, 10], np.int32)
    acc0 = dlc._toy_state([0, 3, 7, 10], "cpu")[1]

    def cond(s):
        return jnp.any(s[0] < lim)

    def body(s):
        i, acc, trips = s
        return (jnp.where(i < lim, i + 1, i),
                (acc * 3 + i + 1) % dlc.MOD, trips + 1)

    want = jax.lax.while_loop(cond, body, (jnp.zeros(4, jnp.int32),
                                           jnp.asarray(acc0.numpy()), 0))
    for unroll in (1, 3, 16):
        with device_loop.unrolled(unroll), device_loop._host_node() as rounds:
            got, stats = device_loop.while_loop(
                *dlc._frames_toy(), dlc._toy_state([0, 3, 7, 10], "cpu")[:2],
                (torch.tensor(lim),), max_iterations=10, key="frames toy",
                folded=True)
        assert got[0].tolist() == np.asarray(want[0]).tolist()
        assert got[1].tolist() == np.asarray(want[1]).tolist()
        assert stats.iterations == int(want[2]) and stats.host_reads == 1
        assert rounds == [max(1, math.ceil(10 / unroll))]
    with device_loop._host_node(), pytest.raises(RuntimeError,
                                                 match="past its bound of 9"):
        device_loop.while_loop(
            *dlc._frames_toy(), dlc._toy_state([0, 3, 7, 10], "cpu")[:2],
            (torch.tensor(lim),), max_iterations=9, key="frames toy",
            folded=True)


@pytest.mark.parametrize("go,count,bound", [(1, 3, 5), (1, 5, 5), (0, 2, 9),
                                            (1, 0, 1), (0, 0, 0)])
def test_continue_plain_follows_the_stop_rule(go, count, bound):
    t = torch.tensor([4, 2], dtype=torch.int32)
    fb = torch.tensor([4, 2 + go], dtype=torch.int32)
    status = torch.tensor([9, -1, 6], dtype=torch.int32)
    more = device_loop._continue_plain(status, torch.tensor(bound),
                                       torch.tensor(count, dtype=torch.int32),
                                       t, fb)
    assert more == device_loop._continues(go, count, bound)
    assert status.tolist() == [go, count, 7]


def test_which_loops_the_card_takes_the_cond_of():
    cond = device_loop.AnyLess(0, 1)
    i32 = torch.zeros(3, dtype=torch.int32)
    state, consts = (i32, torch.ones(3)), (i32, i32 + 1)
    assert device_loop._card_cond(cond, True, state, consts) == (0, 1)
    assert device_loop._card_cond(cond, False, state, consts) is None
    assert device_loop._card_cond(dlc._toy()[0], True, state, consts) is None
    assert device_loop._card_cond(device_loop.AnyLess(1, 1), True, state,
                                  consts) is None  # fp32 state
    assert device_loop._card_cond(cond, True, state,
                                  (i32, i32[:2])) is None  # lengths differ
    assert bool(cond(state, consts)) and not cond(state, (i32, i32))
    assert decoding._frames_left(state, consts).dtype == torch.bool
    assert decoding.folds(dsc.SELECT_BASELINE)
    assert not decoding.folds(dsc.BASELINE)


def test_round_fit_arithmetic():
    # 2 us a step, 20 us a round outside the steps
    def launch(rounds, unroll):
        return (rounds * unroll * 2 + rounds * 20) / 1e3

    times = {u: {"launch_ms": [launch(r, u) + 0.01, launch(r, u)],
                 "replays_ms": [r * u * 2 / 1e3], "rounds": r}
             for u, r in ((4, 125), (16, 32))}
    assert dlc.round_fit(times) == pytest.approx(20.0)


# ---- the card checks' code on the CPU (both sides the plain version) ----

def test_select_card_checks_run_on_the_cpu():
    r = dsc.select_width_cases(device="cpu")
    assert len(r) == 3 * len(dsc.SELECT_WIDTHS)
    assert all(v["max_abs_err"] == 0.0 for v in r.values())
    assert {v["slots"] for v in r.values()} == {0, 1, 2, 4}
    assert dsc.check_select_twice(device="cpu") == len(dsc.SELECT_WIDTHS)
    toys = [dlc.check_frames_toy(case, u, "cpu") for case in sorted(dlc.LIMITS)
            for u in dlc.UNROLLS]
    assert all(t["host_reads"] == 1 for t in toys)
