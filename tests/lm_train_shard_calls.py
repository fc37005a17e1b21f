"""The rank process of ``tests/test_torch_lm_train_shard.py``'s
``compressed_psum`` check: it imports no JAX, so the ranks start without
it."""

import os
import pickle

import numpy as np
import torch

from repro_torch.launch.mesh import init_topology, make_cpu_topology
from repro_torch.train import compression


def compressed_psum_rank(rank: int, world: int, url: str, inputs: str, out_dir: str) -> None:
    """``compressed_psum`` over dp (every rank) of this rank's slice of
    the ``.npz`` at ``inputs`` (``g/<leaf>`` and ``e/<leaf>`` arrays
    stacked over the ranks), with each leaf's int8 codes and scale as it
    computes them, pickled to ``out_dir/rank<rank>.pkl``."""
    torch.set_num_threads(1)
    topo = init_topology("gloo", rank, world, make_cpu_topology(world), url, "cpu")
    with np.load(inputs) as z:
        g = {k[2:]: torch.as_tensor(z[k][topo.dp_rank]) for k in z.files if k.startswith("g/")}
        e = {k[2:]: torch.as_tensor(z[k][topo.dp_rank]) for k in z.files if k.startswith("e/")}
    reduced, errors = compression.compressed_psum(g, e, topo, "dp")
    codes = {k: compression.quantize_int8_jit(g[k] + e[k]) for k in g}
    out = {"reduced": {k: v.numpy() for k, v in reduced.items()},
           "errors": {k: v.numpy() for k, v in errors.items()},
           "q": {k: q.numpy() for k, (q, _) in codes.items()},
           "scale": {k: float(s) for k, (_, s) in codes.items()},
           "dp_rank": topo.dp_rank}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
