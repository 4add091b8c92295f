"""Chain checkpoint/resume as NumPy `.npz` files.

The reference has no checkpointing (results written once at the end,
SURVEY §5); long runs need restartability. Sampler states are pytrees
(chex dataclasses / NamedTuples), so checkpoints capture the full chain
state: trajectories, deltas, online statistics, and the iteration counter.

Each checkpoint is one `step_<k>.npz` holding the pytree's leaves under
their key paths ("state/x", "delta", ...). Restoring against a template
pytree gives the structure back; restoring without one gives the flat
{path: array} mapping.
"""
import os
from typing import Any, Optional

import jax
import numpy as np

_PREFIX, _SUFFIX = "step_", ".npz"


def _key_name(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _flatten(tree):
    """Leaves keyed by their '/'-joined pytree paths."""
    pairs, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key_name(k) for k in path): leaf
            for path, leaf in pairs}, treedef


def _path(directory, step):
    return os.path.join(os.path.abspath(directory), f"{_PREFIX}{step}{_SUFFIX}")


def save_checkpoint(directory: str, step: int, state: Any):
    """Save a sampler-state pytree at `directory/step_<k>.npz`; the write
    is atomic (a partial file never carries the final name)."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    flat, _ = _flatten(state)
    path = _path(directory, step)
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
            try:
                steps.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, target: Any = None):
    """Restore the pytree saved at `step` (default: latest). With `target`
    (an example pytree of the saved structure) the leaves come back in that
    structure, cast to the target's dtypes; without it, as a flat
    {path: array} dict."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    with np.load(_path(directory, step)) as data:
        flat = {k: data[k] for k in data.files}
    if target is None:
        return step, flat
    want, treedef = _flatten(target)
    if set(want) != set(flat):
        raise ValueError(f"checkpoint keys {sorted(flat)} do not match the "
                         f"target's {sorted(want)}")
    leaves = [flat[k].astype(np.asarray(v).dtype) for k, v in want.items()]
    return step, jax.tree_util.tree_unflatten(treedef, leaves)
