"""Checkpointing: atomic, async-capable, in the JAX package's on-disk
layout (the port of ``repro.train.checkpoint``).

Layout: ``<dir>/step_<n>/`` holding one ``leaf_%05d.npy`` per leaf of the
tree, in JAX's flatten order (:mod:`repro_torch.tree`), and
``MANIFEST.json`` (step and leaf file names).  Writes go to a
``.tmp`` directory renamed into place, so a crash mid-save never
corrupts the latest checkpoint, and ``restore`` reads the newest step
with a complete manifest.  A checkpoint written by either package
restores in the other.

bfloat16 leaves are written as the JAX package writes them (numpy's
header descr ``'<V2'``, the raw 16-bit patterns) and read back as a
16-bit view in the dtype of ``like``'s leaf.  (The JAX package's own
``restore`` cannot cast such a leaf back; the port can.)  Nothing here
needs ``ml_dtypes``.

Sharded trees: ``save`` writes each DTensor leaf whole (``full_tensor()``,
a collective every rank joins), rank 0 writes the files, and every rank
waits at a barrier for a synchronous save.  The on-disk format does not
change, so a checkpoint written sharded restores unsharded and the other
way round, and interchanges with the JAX package's.  ``restore(...,
shardings=)`` lays each leaf out by a tree of (mesh, placements) (the
reference's elastic restore onto another mesh).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..tree import tree_leaves, tree_map, tree_unflatten

_BF16_DESCR = "<V2"  # how numpy writes ml_dtypes' bfloat16 (what the JAX package saves)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf, never a view of it: the caller goes on
    updating parameters in place.  A bf16 leaf as its 16-bit patterns."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def _write_leaf(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        header = {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape}
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.require(arr, requirements="C").tobytes())


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3, async_: bool = False):
    """Save a tree.  Every leaf is copied to the host before this
    returns; with ``async_`` the files are written by a thread, which is
    returned (join it), else None."""
    leaves = tree_leaves(tree)
    bf16 = [x.dtype == torch.bfloat16 for x in leaves]
    host = [_to_host(x) for x in leaves]
    sharded = any(isinstance(x, DTensor) for x in leaves)
    if sharded and dist.get_rank() != 0:  # rank 0 writes; the others wait for it
        if not async_:
            dist.barrier()
        return None

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        names = []
        for i, (arr, is_bf16) in enumerate(zip(host, bf16)):
            name = f"leaf_{i:05d}.npy"
            _write_leaf(os.path.join(tmp, name), arr, is_bf16)
            names.append(name)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"step": step, "leaves": names}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if sharded:
        dist.barrier()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
                best = int(d.split("_")[1])
    return best


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A saved leaf in the dtype and on the device of ``like``'s leaf."""
    arr = np.require(arr, requirements="C")  # (ascontiguousarray would make a 0-d array 1-d)
    if arr.dtype.kind == "V":  # 16-bit patterns of a bfloat16 leaf
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"a saved {arr.dtype} leaf cannot restore into {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"a saved leaf of shape {tuple(t.shape)} for one of {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any = None) -> Any:
    """The tree saved at ``step``, in the structure of ``like``, each leaf
    in the dtype and on the device of ``like``'s leaf; with ``shardings``
    (a tree of the same structure holding (mesh, placements), or None for
    a leaf to restore whole) each leaf is laid out on its mesh instead,
    every rank cutting its own shard from the file."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = tree_leaves(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(leaves)}")
    out = [_from_host(np.load(os.path.join(path, n)), lf)
           for n, lf in zip(manifest["leaves"], leaves)]
    tree = tree_unflatten(like, out)
    if shardings is None:
        return tree

    def place(x, sh):
        if sh is None:
            return x
        mesh, placements = sh
        return distribute_tensor(x, mesh, list(placements), src_data_rank=None)

    return tree_map(place, tree, shardings)


def shardings_of(tree) -> Any:
    """The (mesh, placements) of each DTensor leaf of ``tree``, None for a
    plain one: what ``restore(..., shardings=)`` takes to lay a checkpoint
    out as ``tree`` is."""
    return tree_map(lambda x: (x.device_mesh, tuple(x.placements)) if isinstance(x, DTensor)
                    else None, tree)
