"""End-to-end LM training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --ranks 4 --tp 2

Runs the generic train step (``train/train_step.py::build_train_step``
over ``models/lm.py::lm_loss``, the step the ``train_4k`` cells carry)
on the card unless ``--device cpu`` is given, with checkpoint and
resume: if the checkpoint directory holds a step, training resumes from
it idempotently (the data is a pure function of the step index,
``data.lm_batch``).  The flags are the JAX package's
``launch/train.py``'s, ``--device`` aside; as there, ``--reduced`` is
on by default.  A full-width model trains through the library
(``chip_smoke.py`` phases 8c and 8e).

With ``--ranks N`` it trains across N processes, one a rank of the JAX
package's ``make_cpu_topology(N, tp)`` grid (``--tp``; dp = N / tp)
over ``torch.distributed`` (``--backend``: gloo, whose processes may
share one card, or NCCL, one card a process), each holding its blocks of
the params and of the AdamW state (``lm.param_specs``,
``optimizer.state_specs``) and taking its share of every batch.  The
weights are the one-rank run's draws, so the losses are the one-rank
run's; rank 0 prints, and writes checkpoints of whole leaves, which
any grid (or one rank) resumes from.  The vocab must split over tp: a
``--tp`` that does not divide it rounds it up, also at ``--ranks 1``,
where ``--tp`` does nothing else (so one rank trains a tp run's model).

:func:`run_job` runs one training job on a rank (or in one process),
for the checks that hold a run across ranks against one process: a job
is a dict, as ``launch/lm_shard.py``'s, whose ``kind`` is ``"train"``
(``lm_shard.run_world`` spawns the ranks and runs serving and training
jobs alike):

    arch, reduced, over      the config (``lm_shard.job_config``)
    tp                       the grid: ``make_cpu_topology(world, tp)``
    batches                  one batch a step ({'tokens', 'labels'} (B, S)
                             numpy, the whole batch on every rank)
    train, adamw             ``TrainConfig`` and ``AdamWConfig`` fields
    tree / seed              the JAX package's tree (an ``.npz`` path,
                             ``lm_shard.save_tree``'s) or the seeded init
    restore                  a checkpoint directory to resume from
    save                     (directory, step): checkpoint after that step
    grads                    the steps (indices into ``batches``) whose
                             gradients to return: this rank's blocks, as
                             the update reads them, on the host
    grads_file               a path with ``{rank}`` and ``{step}``: those
                             gradients saved there (``torch.save``) and
                             the paths returned in their place

It returns each step's loss, gradient norm, wall, collectives
(``Topology.counts``) and kernel launches, the peak memory on a card,
the seconds of the set-up (draw or restore), of the gradient copies and
of the checkpoint and, where asked, the gradients (``grads``: step ->
tree or path).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import tempfile
import time

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    BACKENDS,
    check_backend,
    init_topology,
    make_cpu_topology,
    spawn_ranks,
)
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import generator, sharded
from repro_torch.train import (
    AdamWConfig,
    Checkpointer,
    TrainConfig,
    build_train_step,
    init_train_state,
    state_specs,
)


def _layouts(cfg, tc: TrainConfig, topo):
    """The params' and the AdamW state's specs on ``topo`` (None: one
    device)."""
    if topo is None:
        return None
    pspecs = lm_mod.param_specs(cfg, topo)
    return {"params": pspecs, "opt": state_specs(pspecs, tc.adamw)}


def _drawn(gen: torch.Generator, cfg, topo) -> dict:
    """The seeded params: every tensor drawn whole, as one device draws
    it, and on a rank of ``topo`` its block kept."""
    if topo is None:
        return lm_mod.init_tree(gen, cfg)
    return lm_mod.params_tree(lm_mod.init_params(gen, cfg, topo))


def _step_fn(cfg, tc: TrainConfig, topo, specs):
    """The train step over ``lm_loss``.  The params and state are updated
    in place (the JAX package's cells donate them); each checkpoint
    copies them to the host first."""
    return build_train_step(lambda p, b: lm_mod.lm_loss(p, b, cfg, topo), tc, donate=True,
                            topo=topo, specs=specs and specs["params"])


def train(args, cfg, dev, topo=None) -> None:
    """The training loop on this rank of ``topo`` (None: one device)."""
    lead = topo is None or topo.rank == 0
    tc = TrainConfig(
        adamw=AdamWConfig(lr=args.lr),
        microbatches=args.microbatches,
        compress_accum=args.compress_accum,
        warmup_steps=max(2, args.steps // 10),
        total_steps=args.steps,
    )
    specs = _layouts(cfg, tc, topo)
    params = _drawn(generator(args.seed, dev), cfg, topo)
    opt = init_train_state(params, tc)
    start = 0

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and ck.latest_step() is not None:
        tree, man = ck.restore(device=dev, topo=topo, specs=specs)
        params, opt, start = tree["params"], tree["opt"], man["step"]
        if lead:
            print(f"[train] resumed from step {start}", flush=True)

    step_fn = _step_fn(cfg, tc, topo, specs)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in lm_batch(step, args.batch, args.seq, cfg.vocab,
                                      args.seed).items()}
        params, opt, m = step_fn(params, opt, batch,
                                 torch.tensor(step, dtype=torch.int32, device=dev))
        if lead and (step % 5 == 0 or step == args.steps - 1):
            print(
                f"[train] step {step:5d} loss={float(m['loss']):.4f} "
                f"gnorm={float(m['grad_norm']):.3f} "
                f"lr={float(m['lr']):.2e} "
                f"({(time.time() - t0):.1f}s)", flush=True
            )
        if ck and (step + 1) % args.ckpt_every == 0:
            ck.save_async(step + 1, {"params": params, "opt": opt}, topo=topo, specs=specs)
    if ck:
        ck.save(args.steps, {"params": params, "opt": opt}, topo=topo, specs=specs)
        if lead:
            print(f"[train] checkpointed step {args.steps}", flush=True)


def run_job(job: dict, topo, device) -> dict:
    """One training job (the module docstring) on this rank of ``topo``
    (None: one process)."""
    from repro_torch import kernels as K
    from repro_torch.launch.lm_shard import job_config, load_tree
    from repro_torch.models.convert import lm_tree_from_numpy, shard_tree

    cfg = job_config(job)
    dev = torch.device(device)
    topo = sharded(topo)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tc = TrainConfig(adamw=AdamWConfig(**job.get("adamw", {})), **job.get("train", {}))
    specs = _layouts(cfg, tc, topo)
    start = 0
    t0 = time.perf_counter()
    if cfg.remat == "full":
        # torch.utils.checkpoint's first call imports torch._dynamo, seconds
        # in a fresh rank process: paid in the set-up, not in the first step
        importlib.import_module("torch._dynamo")
    if job.get("restore"):
        tree, man = Checkpointer(job["restore"]).restore(device=dev, topo=topo, specs=specs)
        params, opt, start = tree["params"], tree["opt"], man["step"]
    else:
        if job.get("tree"):
            params = lm_tree_from_numpy(load_tree(job["tree"]), cfg, device=dev)
            params = params if topo is None else shard_tree(params, specs["params"], topo)
        else:
            params = _drawn(generator(job.get("seed", 0), dev), cfg, topo)
        opt = init_train_state(params, tc)
    step_fn = _step_fn(cfg, tc, topo, specs)
    sync()
    out = {key: [] for key in ("losses", "grad_norms", "walls", "counts", "launches")}
    out.update(rank=0 if topo is None else topo.rank, setup_s=time.perf_counter() - t0,
               files_s=0.0, save_s=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(job["batches"]):
        step = torch.tensor(start + i, dtype=torch.int32, device=dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        if topo is not None:
            topo.counts.clear()
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        loss, grads = step_fn.gradients(params, batch)
        params, opt, m = step_fn.update(params, opt, grads, loss, step)
        out["losses"].append(float(m["loss"]))
        sync()
        out["walls"].append(time.perf_counter() - t0)
        out["grad_norms"].append(float(m["grad_norm"]))
        out["counts"].append({} if topo is None else dict(topo.counts))
        out["launches"].append(dict(K.launch_counts()))
        t0 = time.perf_counter()
        if i in job.get("grads", ()):
            host = tree_map(lambda g: g.detach().cpu(), grads)
            if job.get("grads_file"):
                path = job["grads_file"].format(rank=out["rank"], step=i)
                torch.save(host, path)
                host = path
            out.setdefault("grads", {})[i] = host
        del grads
        out["files_s"] += time.perf_counter() - t0
        if job.get("save") and start + i + 1 == job["save"][1]:
            t0 = time.perf_counter()
            Checkpointer(job["save"][0]).save(start + i + 1, {"params": params, "opt": opt},
                                              topo=topo, specs=specs)
            out["save_s"] += time.perf_counter() - t0
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(coords=None if topo is None else topo.coords, start=start)
    return out


def rank_main(rank: int, world: int, args, cfg, url: str, device: str) -> None:
    """One rank process: join the group on the grid and train (under
    NCCL on a card of its own)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    elif args.backend == "nccl":
        device = f"cuda:{rank}"
    topo = init_topology(args.backend, rank, world, make_cpu_topology(world, args.tp),
                         url, device)
    try:
        train(args, cfg, torch.device(device), topo)
    finally:
        torch.distributed.destroy_process_group()


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
    ap.add_argument("--ranks", type=int, default=1, help="processes, one a rank")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks (dp = ranks / "
                    "tp); the vocab is rounded up to a multiple of it")
    ap.add_argument("--backend", default="gloo", choices=BACKENDS)
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", "") != "lm":
        raise SystemExit("train driver currently targets the LM family; "
                         "use examples/gnn_train.py for GNNs")
    dev = resolve_device(args.device)
    cfg = mod.make_config(reduced=args.reduced)
    vocab = -(-cfg.vocab // args.tp) * args.tp
    if vocab != cfg.vocab:
        print(f"[train] vocab {cfg.vocab} rounded up to {vocab}, a multiple of tp {args.tp}",
              flush=True)
        cfg = dataclasses.replace(cfg, vocab=vocab)
    if args.ranks == 1:
        train(args, cfg, dev)
        return
    grid = make_cpu_topology(args.ranks, args.tp)
    check_backend(args.backend, args.ranks, dev)
    lm_mod.check_trainable(cfg, grid, args.batch // args.microbatches, args.seq)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, args.ranks,
                    (args, cfg, "file://" + os.path.join(tmp, "store"), str(dev)))


if __name__ == "__main__":
    main()
