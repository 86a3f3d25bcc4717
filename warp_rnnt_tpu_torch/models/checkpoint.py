"""Checkpoint and restore for the model tier (counterpart of
`warp_rnnt_tpu/models/checkpoint.py`, which uses orbax).

A training state is the model's ``state_dict``, the optimizer's (when
given) and the step, written with `torch.save` to ``path/step_{n}/state.pt``:
the JAX module's ``step_{n}`` directory layout, one file inside.  Restoring
loads the tensors onto the model's own device and into the given model and
optimizer, as orbax restores into a template.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch

_FILE = "state.pt"


def save_checkpoint(path, model, optimizer=None, step: int = 0):
    """Save the training state under ``path`` (created if needed); an
    existing checkpoint of the same step is replaced.  Returns its
    directory."""
    out = pathlib.Path(path).absolute() / f"step_{step}"
    out.mkdir(parents=True, exist_ok=True)
    state = {"model": model.state_dict(), "step": step}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    tmp = out / (_FILE + ".tmp")
    torch.save(state, tmp)
    tmp.replace(out / _FILE)
    return out


def latest_step(path) -> Optional[int]:
    path = pathlib.Path(path)
    steps = [
        int(p.name.split("_", 1)[1])
        for p in path.glob("step_*")
        if p.name.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_checkpoint(path, model, optimizer=None,
                       step: Optional[int] = None) -> int:
    """Load a state saved by `save_checkpoint` into ``model`` (and
    ``optimizer``, which must then have been saved too); the latest step
    when ``step`` is None.  Returns the restored step."""
    path = pathlib.Path(path).absolute()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    device = next(model.parameters()).device
    state = torch.load(path / f"step_{step}" / _FILE, map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        if "optimizer" not in state:
            raise KeyError(f"step_{step} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return state["step"]
