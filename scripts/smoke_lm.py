#!/usr/bin/env python3
"""Phases 1 (the card and the kernels' build), 7 (the serving kernels
against their plain versions), 8 (minitron-8b serving) and 8b (MLA and
MoE serving: minicpm3-4b, phi3.5-moe and dbrx) of ``chip_smoke.py``
alone, on one NVIDIA GPU: the quickest full-width run of the port's LM
serving paths, with the same checks and the same log lines.

    python3 scripts/smoke_lm.py

Prints the card's name and power limit, the versions, the phases' log,
then one JSON line of phase 7's kernel rows with their launches.
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
    rows, bag = cs.serving_kernels(dev, flush)
    attn, attn32, attn_dbrx = (rows[label] for label in (
        "a minitron prefill", "d fp32 twin prefill", "e dbrx prefill"))
    del flush
    cs.log(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    attn["launches"], attn32["launches"] = cs.lm_serving(dev)
    cs.log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phi, attn_dbrx["launches"], _ = cs.mla_moe_serving(dev)
    attn["launches"] += phi
    cs.log(f"phase 8b took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [attn, attn32, attn_dbrx, bag]}), flush=True)
    cs.log(f"phases 1-8b took {time.perf_counter() - t_start:.1f} s on {card}")


if __name__ == "__main__":
    main()
