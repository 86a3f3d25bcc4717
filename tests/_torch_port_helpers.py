"""Shared inputs for the parity tests of the PyTorch port against the JAX
package.  Everything crosses over as numpy arrays made from a seed, so both
packages see the same bits."""

import functools
import glob
import os
import pickle

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


@functools.cache
def fp32_transducer_class():
    """The JAX `Transducer` with its encoder and joint in fp32 (the same
    parameter tree), a test-side subclass: no JAX file changes.  Flax is
    imported here, not at the top, because the card has none."""
    import jax.numpy as jnp
    from warp_rnnt_tpu.models import transducer as jt
    from warp_rnnt_tpu.models.joint import Joint

    class Fp32Transducer(jt.Transducer):
        def setup(self):
            self.encoder = jt.Encoder(self.encoder_hidden,
                                      compute_dtype=jnp.float32)
            self.predictor = jt.Predictor(self.vocab_size,
                                          self.predictor_hidden)
            self.joint = Joint(self.vocab_size, self.joint_hidden,
                               self.joint_mode, compute_dtype=jnp.float32)

    return Fp32Transducer


def carried_pair(variant, seed, feats, V, H, max_label_len=4):
    """(JAX model, its unboxed params, the port's carried model on the CPU)
    of one Flax tree: ``variant`` "bf16" (the default model) or "fp32"
    (`fp32_transducer_class`, and the port's compute_dtype fp32)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from warp_rnnt_tpu.models import transducer as jt
    from warp_rnnt_tpu_torch.models import carry_flax_transducer

    cls = fp32_transducer_class() if variant == "fp32" else jt.Transducer
    model = cls(vocab_size=V, encoder_hidden=H, predictor_hidden=H,
                joint_hidden=H)
    labels = jnp.zeros((feats.shape[0], max_label_len), jnp.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                                 labels))
    tree = jax.tree_util.tree_map(np.asarray, params)
    cd = torch.float32 if variant == "fp32" else torch.bfloat16
    return model, params, carry_flax_transducer(tree, device="cpu",
                                                compute_dtype=cd)


def spawn_worlds(out_dir, inputs, worlds, timeout=120.0):
    """Run `_torch_distributed_worker.py`'s suites one after the other,
    each a world of gloo processes on the CPU started by
    `parallel.multihost.spawn` (a ``file://`` rendezvous; when a rank fails,
    or after ``timeout`` seconds, every process of the world is killed):
    ``worlds`` {suite: ranks}.  The ``inputs`` (numpy arrays and trees) go
    to ``out_dir/inputs.pkl``.  Returns {suite: [rank 0's results, ...]},
    or {suite: the failure and the failed ranks' tracebacks}."""
    import _torch_distributed_worker as worker
    from warp_rnnt_tpu_torch.parallel.multihost import spawn

    out_dir = str(out_dir)
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    results = {}
    for suite, ranks in worlds.items():
        try:
            spawn(worker.run, ranks, (suite, out_dir), device="cpu",
                  timeout=timeout)
        except RuntimeError as e:
            errs = sorted(glob.glob(os.path.join(out_dir, f"{suite}.*.err")))
            results[suite] = "\n".join(
                [str(e)] + [open(p).read() for p in errs])
            continue
        results[suite] = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"{suite}.{r}.pkl"), "rb") as f:
                results[suite].append(pickle.load(f))
    return results


def world(results, suite):
    """The per-rank results of one world, or a failure with its output."""
    out = results[suite]
    assert not isinstance(out, str), f"world {suite} failed:\n{out}"
    return out
