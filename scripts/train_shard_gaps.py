#!/usr/bin/env python3
"""The gaps between LM training across ranks and one process in bf16:
the loss and every gradient leaf of one train step of a phi3-mini-shaped
model (d 768, 8 heads, d_ff 2048, vocab 8192, 4 layers, B 2 x S 512,
plain blockwise attention) on gloo ranks at tp 2 and at dp 2 x tp 2
(``seq_shard_resid``), against the same step in one process.  The tp
ranks' partial sums are rounded to bf16 before they are summed, which
one process does not do; these readings set phase 8e's bf16 loss
tolerance (``chip_smoke.TRAIN_SHARD_BF16_LOSS_RTOL``).

    PYTHONPATH=src python scripts/train_shard_gaps.py [--device cpu]

Prints, a grid, the loss of rank 0 and of one process, their gap as a
share of the loss, and the five widest leaves' gaps as a share of the
leaf's max |grad|.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "phi3-mini-3.8b"
OVER = dict(n_layers=4, d_model=768, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=8192,
            param_dtype="bfloat16", loss_chunk=128, attn_impl="xla_flash", attn_chunk=128)


def main() -> None:
    from repro_torch.data import lm_batch
    from repro_torch.launch import lm_shard
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_cpu_topology
    from repro_torch.models import lm
    from repro_torch.models.convert import tree_to_numpy, unshard_tree
    from repro_torch.train.checkpoint import _flatten_with_paths as by_path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", help="cpu, or cuda (gloo ranks share the card)")
    args = ap.parse_args()
    batch = lm_batch(0, 2, 512, OVER["vocab"], seed=0)
    job = dict(kind="train", arch=ARCH, reduced=True, over=OVER, tp=2, batches=[batch],
               grads=(0,), seed=1)
    one = train_launch.run_job(job, None, args.device)
    want = by_path(tree_to_numpy(one["grads"][0]))
    cfg = lm_shard.job_config(job)
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            res = lm_shard.run_world(world, [job], tmp, device=args.device, timeout=900)
        topo = make_cpu_topology(world, 2)
        got = by_path(unshard_tree([r[0]["grads"][0] for r in res],
                                   lm.param_specs(cfg, topo), topo))
        gaps = {k: float(np.abs(got[k] - w).max() / np.abs(w).max()) for k, w in want.items()}
        loss, ref = res[0][0]["losses"][0], one["losses"][0]
        widest = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
        print(f"dp {world // 2} x tp 2: loss {loss:.6f}, one process {ref:.6f}, gap "
              f"{abs(loss - ref) / abs(ref):.3g} of it; widest leaves "
              f"{', '.join(f'{k} {g:.3g}' for k, g in widest)}", flush=True)


if __name__ == "__main__":
    main()
