#!/usr/bin/env python3
"""Phases 1 (the card and the kernels' build), 7's backward cases (the
attention backward against its plain version, timed beside sdpa's
backward) and 8c (phi3-mini-3.8b training at full width) of
``chip_smoke.py`` alone, on one NVIDIA GPU: the quickest full-width run
of the port's LM training path, with the same checks and the same log
lines.

    python3 scripts/smoke_train.py

Prints the card's name and power limit, the versions, the phases' log,
then one JSON line of the backward's kernel rows with their launches.
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = cs.attention_bwd_kernels(dev, flush)
    bwd, bwd32 = rows["f phi3-mini train"], rows["i fp32 twin train"]
    del flush
    cs.log(f"phase 7's backward cases took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bwd["launches"], bwd32["launches"] = cs.lm_training(dev, card)
    cs.log(f"phase 8c took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [bwd, bwd32]}), flush=True)
    cs.log(f"phases 1, 7 (backward) and 8c took {time.perf_counter() - t_start:.1f} s "
           f"on {card}")


if __name__ == "__main__":
    main()
