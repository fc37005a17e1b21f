#!/usr/bin/env python3
"""Phase 8d of ``chip_smoke.py`` alone (LM serving across ranks), after
the one run of phase 8b it is held against (phi3.5-moe at full width
and 8 layers, bf16, one process), on one NVIDIA GPU, with the same
checks and log lines.

    python3 scripts/smoke_shard.py

Prints the card's name and power limit, the versions and the phases'
log, then one JSON line of phase 8d's kernel row with its launches (case
e' of phase 7: flash_attention at a tp 2 rank's heads, timed here).
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CASE = "e' phi3.5-moe prefill, a tp 2 rank"  # phase 7's case at a tp rank's heads


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    cs.log(f"kernels built in {K.build().seconds:.2f} s")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    (row,) = cs.attention_cases(
        [c for c in cs.ATTN_CASES if c[0] == CASE],
        lambda shape, dtype: torch.randn(shape, generator=gen, device=dev).to(dtype),
        dev, flush).values()
    del flush
    full = get_arch(cs.SHARD_ARCH).make_config()
    toks = torch.as_tensor(lm_batch(0, cs.LM_BATCH, cs.LM_PROMPT, full.vocab,
                                    seed=cs.SEED)["tokens"], device=dev)
    ref: dict = {}
    t0 = time.perf_counter()
    cs.serve_bf16(dataclasses.replace(full, n_layers=cs.SHARD_LAYERS), toks, dev,
                  f"{cs.SHARD_ARCH} ({cs.SHARD_LAYERS} layers)", keep=ref)
    cs.log(f"phase 8b's {cs.SHARD_ARCH} run took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row["launches"] = cs.sharded_serving(dev, ref, card)
    cs.log(f"phase 8d took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [row]}), flush=True)
    cs.log(f"phases 1, 8b (phi3.5-moe) and 8d took {time.perf_counter() - t_start:.1f} s "
           f"on {card}")


if __name__ == "__main__":
    main()
