#!/usr/bin/env python3
"""DimeNet's gradients with bf16 messages on one NVIDIA GPU: each route
(the ``spmm_ell`` kernel for the segment sums and the gathers'
backward; ``index_add_`` for the sums and ``index_select``'s own
backward, bf16 atomics, for the gathers) against itself and against the
other, leaf by leaf as a share of the leaf's max |grad|, without and
then with ``torch.use_deterministic_algorithms``.  The kernel route
takes no atomics, so it should repeat bit for bit either way; the plain
route's atomics move it run to run unless deterministic algorithms are
on.  The kernel route against the plain route under deterministic
algorithms is the source of ``chip_smoke.py``'s ZOO_BF16_GRAD_TOL.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python3 scripts/zoo_bf16_grads.py [SCALE]

The inputs are ``chip_smoke.py``'s phase 10c: the full_graph_sm graph
and a minibatch_lg block drawn as phase 10b draws it, here from rmat1
at SCALE (default 16; the smoke run's is 21), random weights from the
seed.  Prints the card's name and power limit, then three leaves a
pair.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(scale: int) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import dimenet
    from repro_torch.train.train_step import value_and_grad

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    K.build()
    cs.GIN_SCALE = scale
    dev = torch.device("cuda")
    _, g, b = cs.gin_inference(dev)
    _, blk = cs.gin_training(dev, g, b, card)
    batches = cs.zoo_batches(dev, blk)
    for cell in ("full_graph_sm", "minibatch_lg"):
        cfg = get_arch("dimenet").make_config(False, cell)
        seg = dataclasses.replace(cfg, agg_impl="segment_sum")
        batch = batches[cell]
        params = dimenet.init_params(torch.Generator(device=dev).manual_seed(cs.SEED), cfg)

        def grads(c):
            loss = lambda p, bb: dimenet.node_classification_loss(p, bb, c)  # noqa: E731
            return value_and_grad(loss)(params, batch)[1]

        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            gk1, gk2, gs1, gs2 = grads(cfg), grads(cfg), grads(seg), grads(seg)
            pairs = {"kernel-kernel": (gk1, gk2), "seg-seg": (gs1, gs2),
                     "kernel-seg": (gk1, gs1), "kernel2-seg2": (gk2, gs2)}
            for label, (x, y) in pairs.items():
                gaps = sorted(cs.leaf_gaps(x, y), reverse=True)[:3]
                print(f"{cell} ({cfg.msg_dtype} messages) deterministic={det} {label}: "
                      + ", ".join(f"{v:.3g} {n}" for v, n in gaps), flush=True)
            del gk1, gk2, gs1, gs2, pairs
        torch.use_deterministic_algorithms(False)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
