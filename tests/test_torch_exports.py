"""The port's public names against the JAX package's, package by package.

Each port package's ``__all__`` holds the JAX package's names, less the
ones the port leaves out by design (`flat_arg_formats`: it pins XLA
parameter layouts, see `warp_rnnt_tpu_torch/functional/gather.py`), and
every name in it imports.  The models package also exports the port's own
carriers of a Flax tree (`carry_flax_joint`, `carry_flax_transducer`) and
its layers (`ConvBlock`, `joint_logits`), which JAX's does not."""

import importlib

import numpy as np
import pytest
import torch

NOT_PORTED = {"flat_arg_formats"}
PACKAGES = ("", ".functional", ".models", ".parallel", ".utils")


def _all(name):
    return set(importlib.import_module(name).__all__)


@pytest.mark.parametrize("sub", PACKAGES)
def test_all_matches_jax(sub):
    """The same names as JAX's, less `NOT_PORTED`; the models package may
    add its own."""
    jax_names = _all("warp_rnnt_tpu" + sub) - NOT_PORTED
    port_names = _all("warp_rnnt_tpu_torch" + sub)
    if sub == ".models":
        assert jax_names <= port_names, sorted(jax_names - port_names)
    else:
        assert port_names == jax_names
    assert not port_names & NOT_PORTED


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_exported_name_imports(sub):
    mod = importlib.import_module("warp_rnnt_tpu_torch" + sub)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name


def test_utils_names_match_jax():
    """`from warp_rnnt_tpu_torch.utils import ...` gives the functions of
    `utils/lse.py`, and they agree with JAX's on -inf pairs and finite
    values (rtol and atol 1e-6: XLA's and torch's fp32 exp and log1p differ
    in the last bit now and then)."""
    from warp_rnnt_tpu.utils import NEG_INF as J_NEG_INF
    from warp_rnnt_tpu.utils import logrec_combine as j_combine
    from warp_rnnt_tpu.utils import safe_logaddexp as j_lae
    from warp_rnnt_tpu_torch.utils import (NEG_INF, logrec_combine, lse,
                                           safe_logaddexp)

    assert (safe_logaddexp, logrec_combine) == (lse.safe_logaddexp,
                                                lse.logrec_combine)
    assert NEG_INF == J_NEG_INF == float("-inf")
    rng = np.random.RandomState(0)
    a = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    a[:8] = b[:4] = b[8:12] = -np.inf
    got = safe_logaddexp(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_lae(a, b)), rtol=1e-6,
                               atol=1e-6)
    m1, b1, m2, b2 = (rng.randn(16).astype(np.float32) for _ in range(4))
    for got, want in zip(
            logrec_combine(tuple(map(torch.tensor, (m1, b1))),
                           tuple(map(torch.tensor, (m2, b2)))),
            j_combine((m1, b1), (m2, b2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
