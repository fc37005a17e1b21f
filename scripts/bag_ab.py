#!/usr/bin/env python3
"""Time the port's embedding_bag kernel and the MIND call around it in
several source trees on one NVIDIA GPU, one process a tree, in the
order given: the way to hold a change of
``src/repro_torch/csrc/embedding_bag.cu`` against its parent on the
same card.

    python3 scripts/bag_ab.py PARENT . . PARENT

Each tree is a checkout whose ``src/repro_torch`` is imported and built.
The bag is ``chip_smoke.py``'s phase-7 one, at MIND's serve_bulk
widths: a (2^17, 64) f32 table, B 262,144 bags of the L 16 profile ids
``mind_batch`` makes, f32 weights with about a fifth of them 0.  For
each tree, three rounds of: the wrapper (``chip_smoke.time_ms``, CUDA
events, each call after a write that evicts L2), the bare launch the
same way, and the kernel alone under ``torch.profiler``; then warm
MIND online calls (``serve_interests`` at B 512, wall time each).  In
the script's own tree, the ``VARIANTS`` of ``csrc/embedding_bag.cu``
(row loads a lane issues before its adds, resident blocks asked of
ptxas), each an edited copy of the source built alone, bare and alone
the same way.  Every build is checked bit for bit against the in-order sum
first.  Prints one JSON line a tree.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS, CALLS = 3, 10
#: name -> edits (text of csrc/embedding_bag.cu -> its replacement) of a variant
VARIANTS = {
    "chunk 8": {"kChunk = 4;": "kChunk = 8;"},
    "chunk 4, 6 blocks": {"__launch_bounds__(kThreads)": "__launch_bounds__(kThreads, 6)"},
}


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch
    from repro_torch.kernels.embedding_bag.kernel import _launch
    from repro_torch.models import mind

    dev = torch.device("cuda")
    K.build()
    cfg = get_arch("mind").make_config()
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    B = dict(chip_smoke.MIND_SERVE)["serve_bulk"]
    idx = torch.as_tensor(mind_batch(0, B, cfg, seed=chip_smoke.SEED)["profile_ids"],
                          device=dev)
    table = torch.randn((cfg.n_profile, cfg.embed_dim), generator=gen, device=dev) * 0.02
    u = torch.rand(idx.shape, generator=gen, device=dev)
    w = torch.where(u > 0.2, torch.rand(idx.shape, generator=gen, device=dev), 0.0)
    (L, d), out = (idx.shape[1], table.shape[1]), torch.empty((B, table.shape[1]), device=dev)
    args = (table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), B, L, d,
            torch.cuda.current_stream().cuda_stream)
    builds = {"library": _launch()}
    if tree == ROOT:
        from spmm_ab import variant_entry

        source = tree / "src" / "repro_torch" / "csrc" / "embedding_bag.cu"
        builds.update({name: variant_entry(source, name, edits, "embedding_bag_launch", (4, 3))
                       for name, edits in VARIANTS.items()})
    in_order = torch.zeros_like(out)
    for l in range(L):
        in_order = in_order + table[idx[:, l].long()] * w[:, l, None]
    for name, launch in builds.items():
        out.fill_(float("nan"))
        if launch(*args) != 0:
            sys.exit(f"{name}: the bag kernel failed to launch")
        torch.cuda.synchronize()
        if not torch.equal(out, in_order):
            sys.exit(f"{name}: the bag kernel is not bit-identical to the in-order sum")
    if not torch.equal(K.embedding_bag_cuda(table, idx, w), in_order):
        sys.exit("the wrapper's bag is not bit-identical to the in-order sum")
    model = mind.init_params(torch.Generator(device=dev).manual_seed(chip_smoke.SEED), cfg)
    online = {k: torch.as_tensor(v, device=dev) for k, v in mind_batch(
        1, dict(chip_smoke.MIND_SERVE)["serve_p99"], cfg, seed=chip_smoke.SEED).items()}
    mind.serve_interests(model, online, cfg)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    result: dict = {"tree": str(tree)}
    for _ in range(ROUNDS):
        result.setdefault("wrapper ms", []).append(round(chip_smoke.time_ms(
            lambda: K.embedding_bag_cuda(table, idx, w), flush), 4))
        for name, launch in builds.items():
            result.setdefault(f"{name} bare ms", []).append(round(chip_smoke.time_ms(
                lambda: launch(*args), flush), 4))
            result.setdefault(f"{name} alone ms", []).append(round(chip_smoke.kernel_alone_ms(
                lambda: launch(*args), flush, ("embedding_bag",)), 4))
        for _ in range(CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mind.serve_interests(model, online, cfg)
            torch.cuda.synchronize()
            result.setdefault("online call ms", []).append(
                round((time.perf_counter() - t0) * 1e3, 3))
    print(json.dumps(result), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--tree":
        time_tree(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--tree", tree], check=True)


if __name__ == "__main__":
    main()
