"""LM serving across processes: one process a rank of a ``dp x tp``
grid over ``torch.distributed``, each holding its blocks of the model
(``models/lm.py``'s layouts), prefilling a prompt and decoding greedily.

    PYTHONPATH=src python -m repro_torch.launch.lm_shard \\
        --arch phi3.5-moe-42b-a6.6b --reduced --vocab 200 --world 4 --tp 2 \\
        --batch 4 --prompt 16 --steps 8 [--device cpu]

A job is a dict (picklable, so the same jobs run in every rank):

    arch, reduced, over      the config (``get_arch(arch).make_config``)
                             with the fields of ``over`` replaced
    tp                       the grid: ``make_cpu_topology(world, tp)``
    tokens                   the prompt (B, S), the same on every rank
    max_len, steps, long     the cache's slots, greedy decode steps and
                             layout (``long``: the sequence over every
                             rank, the batch whole)
    forced                   (steps, B) tokens to decode in place of the
                             greedy ones (None: greedy)
    tree                     a path to an ``.npz`` of the JAX package's
                             parameter tree (keys ``embed``,
                             ``layers/<name>``, ...), cut to each rank's
                             blocks by ``convert.shard_tree``; None: the
                             seeded init of ``init_params(topo=)``
    seed                     the seed of that init
    forward                  also run ``lm.forward`` on the prompt (the
                             rank's rows of the final hidden states)
    routes                   also record each MoE layer call's route

:func:`run_job` returns the rank's blocks of the prefill's logits, of
every step's logits and of the cache after the last, the greedy tokens
(all ranks agree on them), each MoE layer call's route where the job
asks (its capacity, experts, kept pairs and top router probabilities), the
kernels' launches in the prefill, the collectives and bytes of the
prefill and of each decode step, walls and, on a card, peak memory.
:func:`run_world` spawns the ranks over gloo (host tensors, or a card's
shared by every rank, staged through host memory) and returns each
rank's results; a job whose ``kind`` is ``"train"`` runs
``launch/train.py::run_job`` instead (training across ranks).  Its ``device`` is the card unless the caller asks for
the CPU (``--device cpu``), as the tests do.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_topology, make_cpu_topology, spawn_ranks, topology_groups


def job_config(job: dict):
    from repro_torch.configs import get_arch

    cfg = get_arch(job["arch"]).make_config(reduced=job.get("reduced", False))
    over = dict(job.get("over") or {})
    if "moe" in over and cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


def load_tree(path: str) -> dict:
    """An ``.npz`` written by :func:`save_tree` as the nested tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return tree


def save_tree(tree: dict, path: str) -> None:
    """A nested tree of numpy arrays as one ``.npz``, keys joined by /."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)

    walk(tree, "")
    np.savez(path, **flat)


@contextlib.contextmanager
def recorded_routes():
    """Yields a list that gets each MoE route of the block: its capacity,
    the (N, k) experts and kept mask and the (N, k + 1) largest router
    probabilities (descending).  They are copied on their device while
    the block runs (no host read) and reach the host as numpy arrays
    when it ends."""
    from repro_torch.models import moe

    real, seen = moe.route, []

    def route(x, router_w, cfg, C):
        r = real(x, router_w, cfg, C)
        k = r.idx.shape[-1]
        seen.append(dict(C=C, idx=r.idx.clone(), keep=r.keep.clone(),
                         top=torch.topk(r.probs, min(k + 1, r.probs.shape[-1])).values))
        return r

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real
        for rec in seen:
            rec.update({k: v.cpu().numpy() for k, v in rec.items() if k != "C"})


def _routes(job: dict):
    """:func:`recorded_routes` where the job asks for them, else a list
    that stays empty."""
    return recorded_routes() if job.get("routes") else contextlib.nullcontext([])


def _host(t):
    return t.detach().float().cpu().numpy()


def build_model(job: dict, cfg, topo, device):
    from repro_torch.models import lm
    from repro_torch.models.common import generator
    from repro_torch.models.convert import lm_params_from_numpy, shard_tree

    if job.get("tree"):
        tree = shard_tree(load_tree(job["tree"]), lm.param_specs(cfg, topo), topo)
        return lm_params_from_numpy(tree, cfg, device=device, topo=topo)
    return lm.init_params(generator(job.get("seed", 0), device), cfg, topo=topo)


def run_job(job: dict, topo, device) -> dict:
    """One job on this rank of ``topo`` (the module docstring)."""
    from repro_torch import kernels as K
    from repro_torch.models import lm

    cfg = job_config(job)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    model = build_model(job, cfg, topo, dev)
    sync()
    out = {"init_s": time.perf_counter() - t0}
    tokens = torch.as_tensor(np.asarray(job["tokens"]), device=dev)
    B, S = tokens.shape
    long, forced = job.get("long", False), job.get("forced")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    topo.counts.clear()
    K.reset_launch_counts()
    with _routes(job) as routes:
        t0 = time.perf_counter()
        cache, logits = lm.prefill_step(model, tokens, cfg, job["max_len"], topo, long=long)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
    out.update(prefill_launches=dict(K.launch_counts()),
               prefill_logits=_host(logits), prefill_routes=routes,
               prefill_counts=dict(topo.counts))
    steps, toks, step_counts, step_routes = [], [], [], []
    t0 = time.perf_counter()
    for step in range(job["steps"]):
        nxt = lm.greedy_tokens(logits, topo, B)
        toks.append(nxt.cpu().numpy())
        feed = nxt if forced is None else torch.as_tensor(np.asarray(forced[step]), device=dev)
        topo.counts.clear()
        with _routes(job) as routes:
            logits, cache = lm.decode_step(model, cache, feed, S + step, cfg, topo, long=long)
        steps.append(_host(logits))
        step_counts.append(dict(topo.counts))
        step_routes.append(routes)
    sync()
    out["decode_s"] = time.perf_counter() - t0
    out.update(step_logits=steps,
               tokens=np.stack(toks) if toks else np.zeros((0, B), np.int32),
               step_counts=step_counts, step_routes=step_routes,
               cache={k: _host(v) for k, v in cache.items()},
               rank=topo.rank, coords=topo.coords)
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if job.get("forward"):
        out["forward"] = _host(lm.forward(model, tokens, cfg, topo))
    return out


def rank_main(rank: int, world: int, url: str, jobs: list, out_dir: str, backend: str,
              device: str) -> None:
    """One rank process: join the group, run each job on its grid, and
    write the results to ``out_dir/rank{rank}.pkl``."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    first = make_cpu_topology(world, jobs[0]["tp"])
    init_topology(backend, rank, world, first, url, device)
    results = []
    for job in jobs:
        topo = topology_groups(make_cpu_topology(world, job["tp"]))
        if job.get("kind") == "train":
            from repro_torch.launch.train import run_job as run_train_job

            results.append(run_train_job(job, topo, device))
        else:
            results.append(run_job(job, topo, device))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


def run_world(world: int, jobs: list, out_dir: str, *, backend: str = "gloo",
              device=None, timeout: float = 600.0) -> list:
    """``jobs`` in ``world`` spawned rank processes sharing one process
    group, their tensors on ``device`` (None: the card); returns
    ``results[rank][job]``."""
    device = str(resolve_device(device))
    os.makedirs(out_dir, exist_ok=True)
    url = "file://" + os.path.join(out_dir, "store")
    spawn_ranks(rank_main, world, (url, jobs, out_dir, backend, device), timeout=timeout)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv=None) -> None:
    from repro_torch.data import lm_batch

    ap = argparse.ArgumentParser(description="LM serving across gloo processes")
    ap.add_argument("--arch", default="phi3.5-moe-42b-a6.6b")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--layers", type=int, help="cut the depth to this many layers")
    ap.add_argument("--vocab", type=int, help="the vocab (a multiple of tp: the reduced "
                    "configs' is prime)")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--long", action="store_true", help="the long_* cache layout")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks' tensors live: the card (shared by every rank "
                    "over gloo) or cpu")
    args = ap.parse_args(argv)
    over = {k: v for k, v in (("n_layers", args.layers), ("vocab", args.vocab))
            if v is not None}
    cfg = job_config(dict(arch=args.arch, reduced=args.reduced, over=over))
    # the cache's slots: the prompt and the steps, up to the chunks' multiple
    n = args.world if args.long else args.tp
    max_len = -(-(args.prompt + args.steps) // (128 * n)) * 128 * n
    job = dict(arch=args.arch, reduced=args.reduced, over=over, tp=args.tp,
               tokens=lm_batch(0, args.batch, args.prompt, cfg.vocab)["tokens"],
               max_len=max_len, steps=args.steps, long=args.long)
    with tempfile.TemporaryDirectory() as tmp:
        res = run_world(args.world, [job], tmp, device=args.device)
    for r, (got,) in enumerate(res):
        print(f"rank {r} {got['coords']}: prefill {got['prefill_s']:.3f} s, {args.steps} "
              f"decode steps {got['decode_s']:.3f} s; collectives a prefill "
              f"{got['prefill_counts']}, a decode step {got['step_counts'][-1]}")
    print("greedy tokens (steps x batch):", res[0][0]["tokens"].tolist())


if __name__ == "__main__":
    main()
