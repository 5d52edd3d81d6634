"""Checkpoint/resume (PyTorch port of `qgdsolver_tpu.utils.checkpoint`).

A checkpoint is the full solver state (prognostic fields + t + dt, the
resume contract) written as `step_<n>.npz` with one `leaf_i` array per leaf
in the JAX flatten order of the state, plus a `.json` sidecar.  The layout
is the JAX package's own, so a checkpoint written by either package restores
into the other: a QGDFoam State flattens to rho, rhoU, rhoE, sc, t, dt, then
the pbc tensors (the JAX State's empty `wt` tuple adds no leaf).  A
Lagrangian `PState` flattens to its fluid State's leaves, then the cloud's
x, u, Tp, dp and active (a serial cloud's dropped count is None: no leaf);
a reacting State's DeviceISAT table dict by sorted key (its counters are
int64 scalars here, two uint32 limbs in the JAX package, so a tabulated
reacting checkpoint restores only into the package that wrote it).

Flatten order follows JAX's pytree rules for the containers a state holds:
NamedTuples, tuples and lists in order, dicts by sorted key, None as an
empty subtree, anything else a leaf.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _unflatten(template, leaves):
    """Rebuild `template`'s structure from the iterator `leaves`."""
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(x, leaves) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    arr = next(leaves)
    if torch.is_tensor(template):
        return torch.as_tensor(arr, dtype=template.dtype,
                               device=template.device)
    return arr


def _as_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(state, directory: str, step: int) -> str:
    """Write the state to `directory/step_<n>.npz` (atomic rename)."""
    os.makedirs(directory, exist_ok=True)
    leaves = _flatten(state)
    path = os.path.join(directory, f"step_{step:012d}.npz")
    tmp = path + ".tmp"
    arrays = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(leaves)}
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, "n_leaves": len(leaves)}
    with open(os.path.join(directory, f"step_{step:012d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str):
    """Largest checkpointed step number, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for fn in os.listdir(directory)
        if (m := re.match(r"step_(\d+)\.npz$", fn))
    ]
    return max(steps) if steps else None


def restore(template_state, directory: str, step: int):
    """Load the checkpoint at `step` into the structure of template_state.
    Each tensor leaf takes the template leaf's dtype and device."""
    n = len(_flatten(template_state))
    path = os.path.join(directory, f"step_{step:012d}.npz")
    with np.load(path) as data:
        if len(data.files) != n:
            raise ValueError(f"{path} holds {len(data.files)} leaves, the "
                             f"template state {n}")
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    return _unflatten(template_state, iter(arrays))


def restore_latest(template_state, directory: str):
    """Resume-from-latestTime: (state, step) or (template_state, None)."""
    step = latest_step(directory)
    if step is None:
        return template_state, None
    return restore(template_state, directory, step), step
