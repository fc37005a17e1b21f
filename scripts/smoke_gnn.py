#!/usr/bin/env python3
"""Phases 1 (the card and the kernels' build), 10 (GIN inference), 10b
(GIN training) and 10c (EGNN, MACE and DimeNet training) of
``chip_smoke.py`` alone, on one NVIDIA GPU: the quickest full-width run
of the port's GNN paths, with the same checks and the same log lines.

    python3 scripts/smoke_gnn.py

Prints the card's name and power limit, the versions, the phases' log,
then one JSON line of their kernel rows.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    cs.log(f"kernels built in {K.build().seconds:.2f} s")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    row, g, b = cs.gin_inference(dev)
    cs.log(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row2, blk = cs.gin_training(dev, g, b, card)
    cs.log(f"phase 10b took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = cs.gnn_zoo(dev, blk, card)
    cs.log(f"phase 10c took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [row, row2] + rows}), flush=True)
    cs.log(f"phases 1-10c took {time.perf_counter() - t_start:.1f} s")


if __name__ == "__main__":
    main()
