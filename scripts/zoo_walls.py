#!/usr/bin/env python3
"""Warm train-step walls of EGNN, MACE and DimeNet on one NVIDIA GPU,
each cell's as the median of several steps: ``chip_smoke.py`` phase
10c's cells (molecule, full_graph_sm, minibatch_lg) at full width,
random weights from the seed, every step through the cell's plan (the
kernel route) and timed to a device sync.  The smoke run keeps one warm
step a cell, which spreads by up to 30% on the host-bound cells.

    PYTHONPATH=src python3 scripts/zoo_walls.py [--root DIR] [--label NAME] [--steps N]

``--root`` imports ``chip_smoke.py`` and ``src/`` from another checkout
(say, a parent commit unpacked with ``git archive``), so that two
commits are timed by the same code: run parent, change, change, parent
on one card in one session and compare only within it.  Prints the
card's name and power limit, then one JSON line a (model, cell): the
cold step, the warm steps, their median, least and most, in ms.
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("molecule", "full_graph_sm", "minibatch_lg")


def block(cs):
    """The minibatch_lg block as ``chip_smoke.py`` phase 10b draws it:
    rmat1 at GIN_SCALE, 1,024 seeds among the vertices with out-edges,
    the cell's fanouts, all from the seed."""
    import numpy as np

    from repro_torch.configs.cells import GNN_SHAPES
    from repro_torch.graph import FanoutSampler, rmat1

    sh = GNN_SHAPES["minibatch_lg"]
    sampler = FanoutSampler(rmat1(cs.GIN_SCALE, seed=cs.SEED), sh["fanouts"], seed=cs.SEED)
    pool = np.flatnonzero(np.diff(sampler.csr.row_ptr))
    seeds = np.random.default_rng(cs.SEED).choice(pool, sh["seeds"], replace=False)
    return sampler.sample(seeds)


def main(root: Path, label: str, steps: int, cells) -> None:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.train import TrainConfig, init_train_state

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    K.build()
    dev = torch.device("cuda")
    batches = cs.zoo_batches(dev, block(cs))
    for name in cs.ZOO_MODELS:
        for cell in cells:
            arch, model = get_arch(name), getattr(gnn, name)
            plan, cfg = arch.make_cell(cell), arch.make_config(False, cell)
            params = model.init_params(torch.Generator(device=dev).manual_seed(cs.SEED), cfg)
            opt = init_train_state(params, TrainConfig())
            walls = []
            for i in range(1 + steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = plan.fn(params, opt, batches[cell], i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            warm = walls[1:]
            print(json.dumps({"label": label, "model": name, "cell": cell, "cold_ms": walls[0],
                              "median_ms": statistics.median(warm), "min_ms": min(warm),
                              "max_ms": max(warm), "warm_ms": warm,
                              "loss": float(m["loss"]), "card": card}), flush=True)
            del params, opt, m
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose chip_smoke.py and src/ are timed (default: this one)")
    ap.add_argument("--label", default=None, help="name printed on each line (default: --root)")
    ap.add_argument("--steps", type=int, default=10, help="warm steps a cell")
    ap.add_argument("--cells", nargs="+", default=CELLS, choices=CELLS)
    opts = ap.parse_args()
    main(opts.root.resolve(), opts.label or str(opts.root), opts.steps, opts.cells)
