"""Shared inputs for the parity tests of the PyTorch port against the JAX
package.  Everything crosses over as numpy arrays made from a seed, so both
packages see the same bits."""

import numpy as np
import pytest
import torch

import golden


def loss_inputs(seed, N=4, T=11, U=5, V=7):
    """Ragged log-softmax log-probs (N, T, U, V) fp32 and int32 labels and
    lengths.  Sample 0 is full; sample 1 has xn=1 and yn=0 where N > 2."""
    rng = np.random.RandomState(seed)
    xs = golden.log_softmax(rng.randn(N, T, U, V)).astype(np.float32)
    ys = rng.randint(1, V, size=(N, U - 1)).astype(np.int32)
    xn = rng.randint(1, T + 1, size=(N,)).astype(np.int32)
    yn = rng.randint(0, U, size=(N,)).astype(np.int32)
    xn[0], yn[0] = T, U - 1
    if N > 2:
        xn[1], yn[1] = 1, 0
    return xs, ys, xn, yn


def gathered(xs, ys, blank=0):
    """(N, T, U, V) + (N, U-1) labels -> blank_lp, emit_lp (N, T, U)."""
    N, T, U, V = xs.shape
    loc = np.concatenate([ys, np.full((N, 1), blank, np.int32)], axis=1)
    emit = np.take_along_axis(
        xs, np.broadcast_to(loc[:, None, :, None], (N, T, U, 1)), axis=-1
    )[..., 0]
    return np.ascontiguousarray(xs[..., blank]), np.ascontiguousarray(emit)


def valid_cells(xn, yn, T, U):
    """(N, T, U) bool: t < xn and u <= yn."""
    t = np.arange(T)[None, :, None]
    u = np.arange(U)[None, None, :]
    return (t < xn[:, None, None]) & (u <= yn[:, None, None])


def tt(*arrays):
    """numpy -> CPU torch tensors (same dtype, copied)."""
    out = tuple(torch.tensor(np.asarray(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: decided when the test runs, never at
    import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")
