"""Fault-tolerant checkpointing: atomic commit, integrity digest,
rotation, resume-from-latest, and an async writer — the JAX package's
``repro.checkpoint.manager`` over the port's trees.

Layout per step:
    <dir>/step_0000123/
        arrays.npz          the tree's leaves in walk order (``a0``, ...)
        manifest.json       the tree's structure, shapes, dtypes, sha256
                            of arrays.npz
        COMMITTED           written LAST -> a crash mid-write never
                            produces a checkpoint that restore will load

A tree is nested dicts, lists and tuples of tensors, walked in
``repro_torch.tree``'s order; the manifest's ``treedef`` is its
``describe`` string (the port's own, not JAX's).  A bfloat16 leaf has
no numpy dtype: its raw 16 bits are stored as uint16 and the manifest's
dtype (``torch.bfloat16``) restores them bit for bit.  ``save`` copies
every leaf to host memory on the caller's thread before it returns or
hands the write to the async thread, so the caller may update its
tensors in place at once.

A tree of DTensors (training over a mesh: the params and moments
placed by the train rules) is saved whole: every rank of the mesh
gathers each leaf (``spmd.full``), the rank at the mesh's origin writes
(at once, even with ``async_write``), and the others wait for it at a
barrier, so the files are a one-rank checkpoint's.  ``restore`` into a
tree of DTensors places each leaf as the tree's is (each rank keeps
its slices), so a checkpoint written on one rank or over any mesh
resumes on one rank or over any mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.dist import spmd


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bfloat16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_numpy``, on ``like``'s device."""
    if dtype == str(torch.bfloat16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if str(t.dtype) != dtype:
        raise IOError(f"checkpoint leaf of dtype {t.dtype}, manifest says "
                      f"{dtype}")
    return t.to(like.device)


def _flatten(tree) -> tuple[list[np.ndarray], list[str], str]:
    leaves = T.leaves(tree)
    return ([_to_numpy(l) for l in leaves], [str(l.dtype) for l in leaves],
            T.describe(tree))


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------

    def save(self, step: int, tree) -> str:
        mesh = spmd.mesh_of(T.leaves(tree))
        if mesh is not None:
            flat = _flatten(T.map_(spmd.full, tree))
            if all(c == 0 for c in mesh.get_coordinate()):
                self._write(step, *flat)
            _barrier(mesh)
            return self._path(step)
        if self.async_write:
            self.wait()
            flat = _flatten(tree)            # snapshot on the caller's thread
            self._thread = threading.Thread(
                target=self._write_async, args=(step, *flat), daemon=True)
            self._thread.start()
            return self._path(step)
        return self._write(step, *_flatten(tree))

    def _write_async(self, *args):
        try:
            self._write(*args)
        except BaseException as e:     # handed to the caller by wait()
            self._error = e

    def wait(self):
        """Join the async write in flight, if any; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:07d}")

    def _write(self, step: int, arrays, dtypes, treedef) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(arrays),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": dtypes,
            "sha256": _digest(npz),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._rotate()
        return final

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- read ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure of ``tree_like`` (new tensors on
        its leaves' devices); verifies the digest, the structure and every
        leaf's shape and dtype."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no committed checkpoint found")
        path = self._path(step)
        npz = os.path.join(path, "arrays.npz")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if _digest(npz) != manifest["sha256"]:
            raise IOError(f"checkpoint {path} failed integrity check")
        if manifest["treedef"] != T.describe(tree_like):
            raise IOError(f"checkpoint {path} holds another tree")
        like = T.leaves(tree_like)
        for i, l in enumerate(like):
            shape, dtype = manifest["shapes"][i], manifest["dtypes"][i]
            if shape != list(l.shape) or dtype != str(l.dtype):
                raise IOError(f"checkpoint {path} leaf {i} is {dtype} "
                              f"{shape}, the tree's is {l.dtype} "
                              f"{list(l.shape)}")
        with np.load(npz) as data:
            leaves = [_from_numpy(data[f"a{i}"], manifest["dtypes"][i], l)
                      for i, l in enumerate(like)]
        leaves = [spmd.place(t, l.device_mesh, l.placements)
                  if spmd.is_dtensor(l) else t for t, l in zip(leaves, like)]
        return T.unflatten(tree_like, leaves), step


def _barrier(mesh):
    """Every rank of ``mesh`` past this point: a barrier over each mesh
    dim's group in turn (the mesh may hold fewer ranks than the
    process group)."""
    import torch.distributed as dist
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))
