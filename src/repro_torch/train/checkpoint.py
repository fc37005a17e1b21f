"""Atomic checkpointing of trees of tensors, in the JAX package's
on-disk format, so that either package reads the other's checkpoints.

Layout:
    <dir>/step_<N>/manifest.json     tree structure + shapes/dtypes
    <dir>/step_<N>/<leaf_path>.npy   one file per tree leaf
    <dir>/LATEST                     text file with the newest step

numpy has no bfloat16, so a bf16 leaf is stored as its uint16 view and
restored through the manifest's dtype name, as the JAX package stores
its ml_dtypes leaves.

Atomicity: the step directory is written as ``.tmp-step_<N>`` and
``os.rename``d into place, then LATEST is updated (rename is atomic on
POSIX): a crashed writer never leaves a half checkpoint visible.

Async: ``save_async`` copies the leaves to host memory synchronously
and writes files on a daemon thread, overlapping I/O with compute;
``wait()`` joins before the next save to bound dirty state.

``restore(device=)`` places every leaf on one device.

A run across ranks (``topo`` of more than one rank, ``specs`` its trees'
layout: the params' ``lm.param_specs`` and the state's
``optimizer.state_specs``) saves whole leaves: every rank sends its
blocks, rank 0 puts each leaf back together by its spec and writes it,
so the JAX package and a one-card run read the checkpoint as any other.
``restore(topo=, specs=)`` reads the whole leaves and keeps this rank's
block of each, on the grid it is given: the counterpart of the JAX
package's ``restore(shardings=)``, which makes a resume elastic across
grids.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import sharded

_SEP = "/"



def _host(v) -> np.ndarray:
    """A leaf as a host numpy array of its own (the caller may go on
    writing its tensors); numpy's dtype-less leaves by ``np.asarray``."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    t = v.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # numpy has none: its uint16 view
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten_with_paths(tree) -> dict:
    flat = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + [str(i)])
        else:
            flat[_SEP.join(path)] = node

    rec(tree, [])
    return flat


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {k: _tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_structure(v) for v in tree]
    return None  # leaf marker


def _unflatten(structure, flat, path=()):
    if isinstance(structure, dict):
        return {k: _unflatten(v, flat, path + (str(k),)) for k, v in structure.items()}
    if isinstance(structure, list):
        return [_unflatten(v, flat, path + (str(i),)) for i, v in enumerate(structure)]
    return flat[_SEP.join(path)]


def _from_storable(v: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_str)
    return torch.from_numpy(v if v.dtype == want else v.view(want))


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------- write ----------

    def _snapshot(self, tree) -> tuple[dict, dict]:
        host, dtypes = {}, {}
        for k, v in _flatten_with_paths(tree).items():
            host[k] = _host(v)
            bf16 = isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
            dtypes[k] = "bfloat16" if bf16 else str(host[k].dtype)
        return host, dtypes

    def save(self, step: int, tree, *, topo=None, specs=None) -> Optional[str]:
        """Write ``tree`` as step ``step``.  Across ranks (``topo``) every
        rank calls this with its blocks and ``specs``; rank 0 writes the
        whole leaves, and the call returns on every rank once the step is
        in place (None but on rank 0)."""
        self.wait()
        tree = _whole(tree, topo, specs)
        if tree is None:
            _barrier(topo)
            return None
        host, dtypes = self._snapshot(tree)
        out = self._write(step, host, dtypes, _tree_structure(tree))
        _barrier(topo)
        return out

    def save_async(self, step: int, tree, *, topo=None, specs=None) -> None:
        """:meth:`save` with the files written on a thread (across ranks
        the blocks are gathered first, on every rank)."""
        self.wait()
        tree = _whole(tree, topo, specs)
        if tree is None:
            return
        host, dtypes = self._snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, dtypes, _tree_structure(tree)),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, dtypes: dict, structure) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = os.path.join(self.dir, f".tmp-step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "structure": structure,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            "n_devices": max(1, torch.cuda.device_count()),
        }
        for k, v in host.items():
            np.save(os.path.join(tmp, k.replace(_SEP, "__") + ".npy"), v)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))
        return final

    # ---------- read ----------

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: Optional[int] = None, device=None, *, topo=None, specs=None):
        """Load a checkpoint (the newest unless ``step`` is given) as a
        tree of tensors on ``device`` (the CPU by default): whole, or
        across ranks (``topo`` of more than one rank, ``specs`` the tree's
        layout on its grid) this rank's block of each leaf.  Returns
        (tree, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for k, meta in manifest["leaves"].items():
            v = _from_storable(np.load(os.path.join(d, k.replace(_SEP, "__") + ".npy")),
                               meta["dtype"])
            flat[k] = v
        tree = _unflatten(manifest["structure"], flat)
        if sharded(topo) is not None:
            from repro_torch.models.convert import shard_tree

            tree = shard_tree(tree, specs, topo)
        if device is not None:
            tree = _to(tree, device)
        return tree, manifest


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _barrier(topo) -> None:
    if sharded(topo) is not None:
        import torch.distributed as dist

        dist.barrier()


def _whole(tree, topo, specs):
    """``tree`` itself, or across ranks (``topo`` of more than one rank)
    the whole leaves put back together from every rank's blocks by their
    ``specs`` on rank 0 (on the host; None on the other ranks).  One
    gather to rank 0 a leaf (gloo's of host tensors)."""
    if sharded(topo) is None:
        return tree
    from repro_torch.models.convert import unshard_tensor

    if isinstance(tree, dict):
        out = {k: _whole(v, topo, specs[k]) for k, v in tree.items()}
        return out if topo.rank == 0 else None
    if isinstance(tree, (list, tuple)):
        out = [_whole(v, topo, s) for v, s in zip(tree, specs)]
        return out if topo.rank == 0 else None
    import torch.distributed as dist

    block = tree.detach()
    if topo.groups.backend == "gloo":
        block = block.cpu()
    block = block.contiguous()
    blocks = [torch.empty_like(block) for _ in range(topo.n_devices)] if topo.rank == 0 else None
    dist.gather(block, blocks, dst=0)
    if topo.rank != 0:
        return None
    return unshard_tensor([b.cpu() for b in blocks], specs, topo)
