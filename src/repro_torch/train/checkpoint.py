"""Checkpoint save and restore for the train loop: the port of
``repro.train.checkpoint``.

Layout per step, the JAX package's:  <dir>/step_<N>/
    manifest.json     step, n_leaves, shapes, dtype names, extra
    leaves.npz        the flattened leaves, keyed leaf_<i>
    tree.json         the tree's structure (JAX writes a pickled
                      ``treedef``; this is the port's own description)

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or numbers. Leaves are flattened in the JAX package's order (dict
keys sorted, lists and tuples in order), so ``leaf_<i>`` of a tree of
(params, optimizer state, error-feedback state) is ``leaf_<i>`` of the
JAX package's checkpoint of the same tree.

bf16 leaves are stored as their 16 bits (an int16 array, dtype name
``"bfloat16"`` in the manifest) and restored as bf16, bit for bit. This
is where the port departs from the reference on purpose: numpy has no
bfloat16, so the JAX package's bf16 leaves come back from ``np.load`` as
2-byte void arrays (ROADMAP C13); their bytes are the same.

Saves are atomic (a temporary directory, then a rename), pruned to the
``keep`` newest, and run on a thread (``async_save``) with one save in
flight; the device-to-host copy is taken before the thread starts, so
the caller may update its tensors in place right after ``save``.

Sharded trees: a tree with DTensor leaves (a train state on a mesh) is
gathered leaf by leaf, whole, on every rank (a collective: every rank
calls ``save``), and rank 0 writes it, as the JAX package writes leaves
whole on one host; the bytes are those of an unsharded save of the same
values. ``wait`` then holds every rank until the write is done.
``restore(..., shardings=specs, mesh=device_mesh)`` places each leaf on
its spec's placement, so a checkpoint written unsharded or on any mesh
restores onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import distribute, is_dtensor


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in the JAX package's order, a JSON description of the
    structure). ``None`` is an empty subtree, as in JAX."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {"dict": {k: walk(t[k]) for k in sorted(t)}}
        if isinstance(t, (list, tuple)):
            return {type(t).__name__: [walk(v) for v in t]}
        if t is None:
            return {"none": None}
        leaves.append(t)
        return "leaf"

    return leaves, walk(tree)


def unflatten(spec: Any, leaves: List[Any]) -> Any:
    """The tree ``flatten`` described, with ``leaves`` in its order."""
    it = iter(leaves)

    def build(s):
        if s == "leaf":
            return next(it)
        (kind, body), = s.items()
        if kind == "dict":
            return {k: build(v) for k, v in body.items()}
        if kind == "none":
            return None
        return {"list": list, "tuple": tuple}[kind](build(v) for v in body)

    return build(spec)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of the leaf, its dtype name); bf16 as its int16 bits.
    A DTensor is gathered whole first (a collective)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device: torch.device
               ) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False             # the last save gathered DTensors
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Checkpoint ``tree`` (the caller bundles params and optimizer
        state) as ``step``, with the JSON-able ``extra``."""
        leaves, spec = flatten(tree)
        sharded = any(is_dtensor(x) for x in leaves)
        host = [_to_host(x) for x in leaves]          # device->host copy
        self.wait()                                   # one save in flight
        self._sharded = sharded
        if sharded and dist.get_rank() != 0:
            return                                    # rank 0 writes
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, host, spec, extra))
            self._thread.start()
        else:
            self._write(step, host, spec, extra)

    def _write_caught(self, *args):
        try:
            self._write(*args)
        except BaseException as e:          # re-raised by wait()
            self._error = e

    def _write(self, step, host, spec, extra):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_ckpt_")
        try:
            np.savez(os.path.join(tmp, "leaves.npz"),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump(spec, f)
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [dt for _, dt in host],
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()

    def wait(self):
        """Block until the save in flight is written; raise its error.
        After a sharded save every rank calls it: a barrier holds the
        other ranks until rank 0 has written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = "cuda", shardings: Any = None,
                mesh=None) -> Tuple[int, Any, dict]:
        """``(step, tree, extra)`` of ``step`` (the newest by default),
        every leaf a tensor on ``device`` in its saved dtype. With
        ``shardings`` (a tree of specs of the same structure, ``None``
        where a leaf or subtree stays a plain tensor) and the
        ``DeviceMesh`` ``mesh``, each leaf is distributed onto its spec's
        placement (every rank of the mesh calls it)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(d, "tree.json")) as f:
            spec = json.load(f)
        with np.load(os.path.join(d, "leaves.npz")) as z:
            leaves = [_from_host(z[f"leaf_{i}"], dt, dev)
                      for i, dt in enumerate(manifest["dtypes"])]
        tree = unflatten(spec, leaves)
        if shardings is not None:
            tree = distribute(tree, shardings, mesh)
        return step, tree, manifest["extra"]
