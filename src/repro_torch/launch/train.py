"""End-to-end LM training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 10

Runs the generic train step (``train/train_step.py::build_train_step``
over ``models/lm.py::lm_loss``, the step the ``train_4k`` cells carry)
on one device, the card unless ``--device cpu`` is given, with
checkpoint and resume: if the checkpoint directory holds a step,
training resumes from it idempotently (the data is a pure function of
the step index, ``data.lm_batch``).  The flags are the JAX package's
``launch/train.py``'s, ``--device`` aside; as there, ``--reduced`` is
on by default.  A full-width model trains through the library
(``chip_smoke.py`` phase 8c).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_mod
from repro_torch.train import (
    AdamWConfig,
    Checkpointer,
    TrainConfig,
    build_train_step,
    init_train_state,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-accum", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", "") != "lm":
        raise SystemExit("train driver currently targets the LM family; "
                         "use examples/gnn_train.py for GNNs")
    dev = resolve_device(args.device)
    cfg = mod.make_config(reduced=args.reduced)
    tc = TrainConfig(
        adamw=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        compress_accum=args.compress_accum,
        warmup_steps=max(2, args.steps // 10),
        total_steps=args.steps,
    )

    params = lm_mod.init_tree(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    opt = init_train_state(params, tc)
    start = 0

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        tree, man = ck.restore(device=dev)
        params, opt, start = tree["params"], tree["opt"], man["step"]
        print(f"[train] resumed from step {start}")

    # the params and state are updated in place (the JAX package's cells
    # donate them); each checkpoint copies them to the host first
    step_fn = build_train_step(lambda p, b: lm_mod.lm_loss(p, b, cfg), tc, donate=True)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in lm_batch(step, args.batch, args.seq, cfg.vocab,
                                      args.seed).items()}
        params, opt, m = step_fn(params, opt, batch,
                                 torch.tensor(step, dtype=torch.int32, device=dev))
        if step % 5 == 0 or step == args.steps - 1:
            print(
                f"[train] step {step:5d} loss={float(m['loss']):.4f} "
                f"gnorm={float(m['grad_norm']):.3f} "
                f"lr={float(m['lr']):.2e} "
                f"({(time.time() - t0):.1f}s)"
            )
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save_async(step + 1, {"params": params, "opt": opt})
    if ck:
        ck.save(args.steps, {"params": params, "opt": opt})
        print(f"[train] checkpointed step {args.steps}")


if __name__ == "__main__":
    main()
