#!/usr/bin/env python3
"""Time the port's spmm_ell kernel, bare launch, in several source trees
on one NVIDIA GPU, one process a tree, in the order given: the way to
hold a change of ``src/repro_torch/csrc/spmm_ell.cu`` against its parent
on the same card.

    python3 scripts/spmm_ab.py PARENT . . PARENT

Each tree is a checkout whose ``src/repro_torch`` is imported and built.
Shapes: the GIN layer widths (d = 100 and 64) over a synthetic neighbour
ELL of the ``ogb_products`` cell's size (R 2,887,373 rows of W 64 slots,
34.4% filled with uniform random sources among 2,097,152 nodes, the rest
padding on the zero row), both ops; each time is the mean of
``chip_smoke.TIMING_REPS`` launches, each after a write that evicts L2,
taken three times.  Prints one line a tree.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, R, W, FILL = 2_097_152, 2_887_373, 64, 0.344


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels.spmm_ell.kernel import _launch

    dev = torch.device("cuda")
    K.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    filled = torch.rand((R, W), generator=gen, device=dev) < FILL
    col = torch.where(filled, torch.randint(0, N, (R, W), generator=gen, device=dev), N)
    col = col.to(torch.int32).contiguous()
    wgt = torch.where(filled, torch.rand((R, W), generator=gen, device=dev), 0.0).contiguous()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    launch, stream = _launch(), torch.cuda.current_stream().cuda_stream
    times: dict[str, list[float]] = {}
    for _ in range(3):
        for d in (100, 64):
            x = torch.randn((N + 1, d), generator=gen, device=dev)
            x[N] = 0
            out = torch.empty((R, d), device=dev)
            for op, name in enumerate(("sum", "max")):
                args = (x.data_ptr(), col.data_ptr(), wgt.data_ptr(), out.data_ptr(),
                        R, W, d, op, stream)
                ms = chip_smoke.time_ms(lambda: launch(*args), flush)
                times.setdefault(f"d={d} {name}", []).append(round(ms, 4))
    print(f"{tree}: {times} ms", flush=True)


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
