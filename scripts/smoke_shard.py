#!/usr/bin/env python3
"""Phase 8d of ``chip_smoke.py`` alone (LM serving across ranks), after
the one run of phase 8b it is held against (phi3.5-moe at full width
and 8 layers, bf16, one process), on one NVIDIA GPU, with the same
checks and log lines; or, with ``--train``, phase 8e alone (LM training
across ranks: phi3-mini at full width and 4 layers on gloo ranks sharing
the card, against one process), after phase 7's attention cases at a tp
2 rank's heads of its train steps.

    python3 scripts/smoke_shard.py
    python3 scripts/smoke_shard.py --train

Prints the card's name and power limit, the versions and the phases'
log, then one JSON line of the phase's kernel rows with their launches
(phase 8d: case e' of phase 7, flash_attention at a tp 2 rank's heads,
timed here; phase 8e: cases j-k' and l-m').
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
CASE = "e' phi3.5-moe prefill, a tp 2 rank"  # phase 7's case at a tp rank's heads


def serving(cs, dev, gen, card) -> list:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
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
    return [row]


def training(cs, dev, gen, card) -> list:
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fwd_labels = {f for f, _ in cs.TRAIN_SHARD_ROWS.values()}
    bwd_labels = {b for _, b in cs.TRAIN_SHARD_ROWS.values()}
    fwd = cs.attention_cases(
        [c for c in cs.ATTN_CASES if c[0] in fwd_labels],
        lambda shape, dtype: torch.randn(shape, generator=gen, device=dev).to(dtype),
        dev, flush)
    real = cs.ATTN_BWD_CASES
    cs.ATTN_BWD_CASES = tuple(c for c in real if c[0] in bwd_labels)
    try:
        bwd = cs.attention_bwd_kernels(dev, flush)
    finally:
        cs.ATTN_BWD_CASES = real
    del flush
    cs.free_card()
    t0 = time.perf_counter()
    for key, (n_fwd, n_bwd) in cs.sharded_training(dev, card).items():
        f, b = cs.TRAIN_SHARD_ROWS[key]
        fwd[f]["launches"], bwd[b]["launches"] = n_fwd, n_bwd
    cs.log(f"phase 8e took {time.perf_counter() - t0:.1f} s")
    return list(fwd.values()) + list(bwd.values())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="phase 8e in place of 8d")
    opts = ap.parse_args()
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
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = (training if opts.train else serving)(cs, dev, gen, card)
    print(json.dumps({"kernels": rows}), flush=True)
    cs.log(f"phases 1, {'7 (its tp rank train cases) and 8e' if opts.train else '8b (phi3.5-moe) and 8d'} "
           f"took {time.perf_counter() - t_start:.1f} s on {card}")


if __name__ == "__main__":
    main()
