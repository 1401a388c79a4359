"""Checkpoints with rotation and training-state resume (counterpart of
rwkvtts_tpu/train/checkpoint.py, with ``torch.save`` in place of orbax).

Layout: <root>/step_<n>/state.pt holds {"params", "opt_state", "step"} and
<root>/step_<n>/meta.json the data position (epoch, batch) for a
mid-epoch resume; only the newest ``keep`` step directories stay.

On a device mesh (``mesh`` and the sharded ``optimizer`` given) a save
gathers the shards of the parameters and of the optimizer state, rank 0
writes the single-device format and every rank waits for it; a restore
reads the whole file on every rank and keeps the rank's shards. So a
checkpoint moves between any two mesh shapes, one process included.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from rwkvtts_torch.parallel import train_step
from rwkvtts_torch.parallel.train_step import TrainState


def _ckpt_dirs(root: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.isdir(os.path.join(root, name)):
            try:
                out.append((int(name.split("_")[1]), os.path.join(root, name)))
            except ValueError:
                pass
    return sorted(out)


def save(root: str, state: TrainState, meta: Optional[Dict[str, Any]] = None,
         keep: int = 2, mesh=None, optimizer=None) -> str:
    """Write step_<state.step>/ (state.pt + meta.json), then drop all but
    the newest `keep` step directories. The files are written under a
    temporary name first, so a cut save leaves no half-written step. On a
    `mesh`, rank 0 writes the gathered state."""
    path = os.path.abspath(os.path.join(root, f"step_{state.step}"))
    if mesh is not None:
        state = train_step.gather_state(state, optimizer, mesh)
        if mesh.rank == 0:
            save(root, state, meta, keep)
        mesh.barrier()
        return path
    tmp = path + ".tmp"
    os.makedirs(root, exist_ok=True)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"params": state.params, "opt_state": state.opt_state, "step": state.step},
               os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for _, old in _ckpt_dirs(root)[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def latest_step(root: str) -> Optional[int]:
    dirs = _ckpt_dirs(root)
    return dirs[-1][0] if dirs else None


def restore(root: str, like: TrainState, step: Optional[int] = None, mesh=None,
            optimizer=None) -> Tuple[TrainState, Dict[str, Any]]:
    """(state, meta) of step `step` (default: the newest), with every
    tensor on the device of the matching tensor of `like`; on a `mesh`,
    the rank's shards of it."""
    if step is None:
        step = latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step}")
    device = next(iter(_leaves(like.params))).device
    blob = torch.load(os.path.join(path, "state.pt"), map_location=device,
                      weights_only=True)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    state = TrainState(blob["params"], blob["opt_state"], int(blob["step"]))
    if mesh is not None:
        state = train_step.shard_state(state, optimizer, mesh)
    return state, meta


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree
