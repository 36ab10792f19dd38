"""Checkpoints with async save and in-place restore. Port of
``repro.ckpt.checkpoint``; the files are the reference's.

Layout: ``<dir>/step_<N>/{meta.json, arrays.npz}`` plus a ``COMMIT`` marker
written last — a restart only ever resumes from a directory with COMMIT, so
a failure mid-save can never corrupt training. Keys are the reference's
flattened paths (``params/groups/0/stacked/0/ssm/A_log``, dict keys and list
indices joined by ``/``); bf16 leaves are widened to f32 on save (npz holds
no bf16) and cast back on restore. A checkpoint written by either package
restores in the other.

The train state is updated in place (``train.optimizer``), so ``save``
copies every leaf to the host BEFORE it returns, also with
``blocking=False``: only the file write goes to the thread, and the next
step cannot tear the checkpoint. ``restore`` copies INTO the tensors of
``like`` and returns that tree: their addresses are kept, so a train step
captured as a CUDA graph over them stays valid. With ``sharding`` (a
``NamedSharding`` tree, e.g. ``runtime.elastic.state_sharding(state,
mesh)`` for a mesh other than the one that wrote the checkpoint), each
restored tensor is then placed as ``runtime.elastic.reshard_state`` would
place it: kept where its sharding's device is already its own. On a mesh
of ranks (``sharding.spmd``) each rank reads each array and keeps only its
shard, copied from the host to its device, and the tensors of ``like``
(which may be ``meta`` tensors: shapes and dtypes alone) are not written:
the restored tree is new DTensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.sharding.partition import place
from repro_torch.train.optimizer import leaves_with_path


def _flatten(tree) -> dict:
    return {"/".join(str(p) for p in path): leaf
            for path, leaf in leaves_with_path(tree)}


def _rebuild(tree, flat: dict, path=()):
    """``tree``'s structure with the leaf at each flattened path taken from
    ``flat``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, path + (i,))
                          for i, v in enumerate(tree))
    return flat["/".join(str(p) for p in path)]


def _to_numpy(t) -> np.ndarray:
    """A host copy (never a view: a CPU state is updated in place too);
    bf16 (which npz cannot hold) widened to f32, exactly."""
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, tree: Any, blocking: bool = True,
         keep: int = 3) -> threading.Thread:
    """Write a checkpoint; returns the writer thread (joined if blocking).
    The device -> host copy is done before this returns."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "treedef": "repro_torch nested "
                       "dicts/lists", "keys": sorted(flat)}, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        _gc(ckpt_dir, keep)

    t = threading.Thread(target=_write)
    t.start()
    if blocking:
        t.join()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        d = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and os.path.exists(
                os.path.join(d, "COMMIT")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


@torch.no_grad()
def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            sharding: Any = None) -> tuple:
    """Copy the checkpoint (the last committed one, or ``step``) into the
    tensors of ``like``, each cast to its tensor's dtype, and return
    (like, step); with ``sharding``, (like with each tensor placed by its
    sharding, step)."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    shardings = None
    if sharding is not None:
        flat_sh = _flatten(sharding)
        if any(sh.mesh.is_spmd for sh in flat_sh.values()):
            shardings = flat_sh
    with np.load(os.path.join(d, "arrays.npz")) as data:
        flat_like = _flatten(like)
        missing = set(flat_like) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]}...")
        placed = {}
        for key, leaf in flat_like.items():
            arr = torch.from_numpy(np.array(data[key]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {key}: shape "
                                 f"{tuple(arr.shape)}, state "
                                 f"{tuple(leaf.shape)}")
            if shardings is not None:
                placed[key] = place(arr, shardings[key]).to(leaf.dtype)
            else:
                leaf.copy_(arr.to(leaf.dtype))
    if shardings is not None:
        return _rebuild(like, placed), step
    if sharding is not None:
        like = pytree.tree_map(place, like, sharding)
    return like, step
