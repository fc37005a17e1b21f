#!/usr/bin/env python3
"""Time the port's spmm_ell kernel and the GIN forward around it in
several source trees on one NVIDIA GPU, one process a tree, in the
order given: the way to hold a change of
``src/repro_torch/csrc/spmm_ell.cu`` or of the neighbour sum against
its parent on the same card.

    python3 scripts/spmm_ab.py PARENT . . PARENT

Each tree is a checkout whose ``src/repro_torch`` is imported and built.
For each tree, three rounds of:

* the row entry, bare launch, at the GIN layer widths (d = 100 and 64)
  over a synthetic neighbour ELL of the ``ogb_products`` cell's size
  (R 2,887,373 rows of W 64 slots, 34.4% filled with uniform random
  sources among 2,097,152 nodes, the rest padding on the zero row),
  both ops;
* where the tree has it, the vertex sum (``spmm_ell_vertex_cuda``) over
  the neighbour ELL of ``chip_smoke.py``'s phase-10 graph (rmat1 scale
  21, seed 0, generated once and kept in ``build/spmm_ab/``), bare
  launch and alone under ``torch.profiler``, at both widths and at each
  split threshold of ``SPLIT_SWEEP`` (vertices of more rows than it go
  through the scratch rows and the fold), checked bit for bit against
  the default threshold's result first; in the script's own tree also
  the ``VARIANTS`` of ``csrc/spmm_ell.cu`` (gathers in flight a lane,
  resident blocks asked of ptxas), each an edited copy of the source
  built alone into ``build/spmm_ab/`` and checked the same way;
* warm gin-tu forwards (``ogb_products`` cell, random weights from the
  seed) over that graph through the tree's own neighbour sum, wall time
  each; in the first round one more under ``torch.profiler``.

Kernel times are means of ``chip_smoke.TIMING_REPS`` launches, each
after a write that evicts L2.  Prints one JSON line a tree.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "spmm_ab"
N, R, W, FILL = 2_097_152, 2_887_373, 64, 0.344
ROUNDS, FORWARDS = 3, 5
SPLIT_SWEEP = (1, 2, 4, 16)
#: name -> edits (text of csrc/spmm_ell.cu -> its replacement) of a variant
#: of the vertex sum
VARIANTS = {
    "unroll 8, 4 blocks": {"kUnroll = 4;": "kUnroll = 8;",
                           "kVertexMinBlocks = 6;": "kVertexMinBlocks = 4;"},
    "unroll 4, 5 blocks": {"kVertexMinBlocks = 6;": "kVertexMinBlocks = 5;"},
    "unroll 4, 7 blocks": {"kVertexMinBlocks = 6;": "kVertexMinBlocks = 7;"},
}
VERTEX_ARGS = 11, 6  # pointers, ints of spmm_ell_vertex_launch (then the stream)


def variant_entry(source: Path, name: str, edits: dict, symbol: str, args: tuple):
    """``symbol`` of a copy of ``source`` with ``edits`` made (each text
    found exactly once), built alone with the library's nvcc flags into
    build/spmm_ab/; ptxas's register report printed."""
    import ctypes

    from repro_torch.kernels import _lib

    text = source.read_text()
    for old, new in edits.items():
        if text.count(old) != 1:
            sys.exit(f"{name}: {old!r} is not in {source.name} exactly once")
        text = text.replace(old, new)
    stem = f"{source.stem}_{'_'.join(name.replace(',', '').split())}"
    copy, out = CACHE / "variants" / f"{stem}.cu", CACHE / "variants" / f"{stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(text)
    done = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(copy),
                           "-o", str(out)], capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {source.name} ({name}):\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[{name}] {line.strip()}", flush=True)
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes = [_lib.ptr] * args[0] + [_lib.c_int] * args[1] + [_lib.ptr]
    fn.restype = _lib.c_int
    return fn


def load_batch():
    """chip_smoke's phase-10 batch (gnn_flat_batch of rmat1 at GIN_SCALE),
    made by the first tree's process and read back by the others."""
    import numpy as np

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.data import gnn_flat_batch
    from repro_torch.graph import rmat1

    cfg = get_arch("gin-tu").make_config(False, chip_smoke.GIN_CELL)
    path = CACHE / f"gin_rmat1_s{chip_smoke.GIN_SCALE}_seed{chip_smoke.SEED}.npz"
    if not path.exists():
        g = rmat1(chip_smoke.GIN_SCALE, seed=chip_smoke.SEED)
        batch = gnn_flat_batch(g, cfg.d_in, cfg.n_classes, seed=chip_smoke.SEED)
        CACHE.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **{k: batch[k] for k in ("x", "edge_src", "edge_dst", "edge_mask")})
        tmp.replace(path)
    return cfg, dict(np.load(path))


def time_rows(result: dict, flush) -> None:
    """The row entry, bare launch, over the synthetic ELL."""
    import torch

    import chip_smoke
    from repro_torch.kernels.spmm_ell.kernel import _launch

    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(0)
    filled = torch.rand((R, W), generator=gen, device=dev) < FILL
    col = torch.where(filled, torch.randint(0, N, (R, W), generator=gen, device=dev), N)
    col = col.to(torch.int32).contiguous()
    wgt = torch.where(filled, torch.rand((R, W), generator=gen, device=dev), 0.0).contiguous()
    launch, stream = _launch(), torch.cuda.current_stream().cuda_stream
    for d in (100, 64):
        x = torch.randn((N + 1, d), generator=gen, device=dev)
        x[N] = 0
        out = torch.empty((R, d), device=dev)
        for op, name in enumerate(("sum", "max")):
            args = (x.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                    R, W, d, op, stream)
            ms = chip_smoke.time_ms(lambda: launch(*args), flush)
            result.setdefault(f"rows d={d} {name} ms", []).append(round(ms, 4))


def time_vertex(ell, result: dict, flush, variants: dict, checked: set) -> None:
    """The vertex sum at each split threshold, bare (and alone, the
    library's build) for the library and each variant."""
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels.spmm_ell.kernel import (
        SPLIT_ROWS,
        _vertex_launch,
        vertex_launch_args,
        vertex_plan,
    )

    gen = torch.Generator(device=flush.device).manual_seed(1)
    builds = {"library": _vertex_launch(), **variants}
    for d in (100, 64):
        x = torch.randn((ell.n, d), generator=gen, device=flush.device)
        want = K.spmm_ell_vertex_cuda(x, ell.col, ell.wgt, ell.row_ptr, ell.deg)
        for split in SPLIT_SWEEP:
            plan = vertex_plan(x, ell.col, ell.row_ptr, ell.deg, split)
            scratch = torch.empty((plan.fat_row.shape[0], d), device=x.device)
            out = torch.empty_like(want)
            args = vertex_launch_args(x, ell.col, ell.wgt, ell.row_ptr, ell.deg, plan,
                                      scratch, out)
            result.setdefault(f"split={split} fat vertices, rows",
                              [plan.fat_vertex.shape[0], plan.fat_row.shape[0]])
            for name, launch in builds.items():
                if (name, d, split) not in checked:
                    out.fill_(float("nan"))
                    if launch(*args) != 0:
                        sys.exit(f"{name}: the vertex sum failed to launch at split {split}")
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                        sys.exit(f"{name}: the vertex sum at split {split}, d={d} differs "
                                 f"from the library's at the default split")
                    checked.add((name, d, split))
                rec = f"vertex d={d} split={split} {name}"
                result.setdefault(f"{rec} bare ms", []).append(round(chip_smoke.time_ms(
                    lambda: launch(*args), flush), 4))
                if name == "library":
                    result.setdefault(f"{rec} alone ms", []).append(round(
                        chip_smoke.kernel_alone_ms(lambda: launch(*args), flush,
                                                   ("vertex_sum_kernel", "vertex_fold_kernel")),
                        4))
    vertex_plan(x, ell.col, ell.row_ptr, ell.deg, SPLIT_ROWS)  # the forward's, before it runs


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.models.gnn import gin, neighbor_ell

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.build()
    cfg, batch = load_batch()
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    del batch
    args = (b["x"], b["edge_src"], b["edge_dst"], b["edge_mask"])
    ell = neighbor_ell(b["edge_src"], b["edge_dst"], b["edge_mask"], N)
    has_vertex = hasattr(K, "spmm_ell_vertex_cuda")
    params = gin.init_params(torch.Generator(device=dev).manual_seed(chip_smoke.SEED), cfg)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    result: dict = {"tree": str(tree), "vertex entry": has_vertex}
    checked: set = set()
    variants = {}
    if has_vertex and tree == ROOT:
        source = tree / "src" / "repro_torch" / "csrc" / "spmm_ell.cu"
        variants = {name: variant_entry(source, name, edits, "spmm_ell_vertex_launch",
                                        VERTEX_ARGS) for name, edits in VARIANTS.items()}
    gin.forward(params, *args, cfg)  # cold: plans and caches
    for rnd in range(ROUNDS):
        time_rows(result, flush)
        if has_vertex:
            time_vertex(ell, result, flush, variants, checked)
        for _ in range(FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gin.forward(params, *args, cfg)
            torch.cuda.synchronize()
            result.setdefault("forward ms", []).append(
                round((time.perf_counter() - t0) * 1e3, 3))
        if rnd == 0:
            with chip_smoke.device_profile(f"{tree}: one warm GIN forward", top=10):
                gin.forward(params, *args, cfg)
                torch.cuda.synchronize()
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
