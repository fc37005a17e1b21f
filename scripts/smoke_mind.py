#!/usr/bin/env python3
"""Phases 1 (the card and the kernels' build), 9 (MIND serving) and 9b
(MIND training at full width, the train_batch cell at B 65,536) of
``chip_smoke.py`` alone, on one NVIDIA GPU: the quickest full-width run
of the port's MIND paths, with the same checks and the same log lines.

    python3 scripts/smoke_mind.py

Prints the card's name and power limit, the versions, the phases' log,
then one JSON line of phase 9b's kernel rows with their launches.
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    launches = cs.mind_serving(dev)
    cs.log(f"phase 9 took {time.perf_counter() - t0:.1f} s: {launches} embedding_bag launches")
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = cs.mind_training(dev, flush, card)
    del flush
    cs.log(f"phase 9b took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows)}), flush=True)
    cs.log(f"phases 1, 9 and 9b took {time.perf_counter() - t_start:.1f} s on {card}")


if __name__ == "__main__":
    main()
