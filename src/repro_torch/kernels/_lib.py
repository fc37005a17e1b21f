"""Build, load and count the port's CUDA kernels.

The sources in ``repro_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, never at import: one
``nvcc -c`` per source, all started together, then one link, into
``build/repro_torch/<digest>/`` at the repository root (``.gitignore``
lists ``build/``).  A library whose sources are unchanged is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.  Each
wrapper counts its launches through :func:`count_launch`, so a run can
show that a path went through its kernels.  Each public op counts its
calls by route (``cuda``: the kernel, ``ref``: the plain version a CPU
tensor takes) through :func:`count_call` or :func:`kernel_call`, so a
run on either device shows which ops a path called; the frontier ops'
:func:`kernel_call` also tells listeners (``roofline/ops.py``'s
recorder) where a call starts and ends.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libminplus.so"

#: the kernels of the library, by the name their wrappers count under
KERNELS = ("fused_superstep", "relax_push_gather", "relax_ell",
           "flash_attention", "flash_attention_bwd", "embedding_bag", "spmm_ell",
           "fused_superstep_batch", "relax_push_gather_batch")

#: the routes a public op takes
ROUTES = ("cuda", "ref")

_launches = dict.fromkeys(KERNELS, 0)
_shapes: dict = {k: {} for k in KERNELS}
_calls = {k: dict.fromkeys(ROUTES, 0) for k in KERNELS}
_listeners: list = []
_lib: "ctypes.CDLL | None" = None
_build: "Build | None" = None

ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when a finished library was reused
    log: str        # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
        "port's CUDA kernels need the CUDA toolkit to build"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile the library if no build of the current sources exists."""
    global _build
    if _build is not None:
        return _build
    out = BUILD_ROOT / _digest() / LIB_NAME
    if out.exists():
        _build = Build(out, 0.0, "")
        return _build
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = []
        for src, proc in zip(_sources(), procs):
            text, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} (exit {proc.returncode}):\n{text}"
                )
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)  # atomic publish for concurrent builders
    _build = Build(out, time.perf_counter() - t0, "\n".join(logs))
    return _build


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        lib.minplus_error_string.argtypes = [c_int]
        lib.minplus_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(symbol: str, argtypes: list):
    """A C entry point of the library with its signature declared."""
    fn = getattr(library(), symbol)
    fn.argtypes = argtypes
    fn.restype = c_int
    return fn


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = library().minplus_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed, error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")


def check_cuda_tensors(kernel: str, **tensors: torch.Tensor) -> None:
    """Every tensor contiguous on the current CUDA device.  Messages are
    formatted only on failure: this runs before every launch."""
    for name, t in tensors.items():
        if not t.is_cuda:
            require(False, kernel, f"{name} must be a CUDA tensor, got {t.device}")
    index = torch.cuda.current_device()
    for name, t in tensors.items():
        if t.device.index != index:
            require(False, kernel, f"{name} must lie on the current CUDA device "
                                   f"cuda:{index}, got {t.device}")
        if not t.is_contiguous():
            require(False, kernel, f"{name} must be contiguous")


def count_tensor(count, like: torch.Tensor) -> torch.Tensor:
    """The live-row count as the (1,) int32 device tensor the frontier
    kernels read (a tensor stays on the device: no host sync)."""
    if isinstance(count, torch.Tensor):
        if count.numel() != 1 or count.dtype != torch.int32:
            require(False, "count", f"must be one int32 element, got "
                                    f"{count.dtype} {tuple(count.shape)}")
        return count.reshape(1)
    return torch.full((1,), int(count), dtype=torch.int32, device=like.device)


def check_frontier_args(kernel: str, dist, row_idx, row_src, col, wgt) -> None:
    """dtypes and shapes of a frontier kernel's (dist, row_idx, row_src,
    col, wgt).  Messages are formatted only on failure: this runs before
    every launch."""
    if dist.dtype != torch.float32 or dist.dim() != 1:
        require(False, kernel, f"dist must be 1-D float32, got {dist.dtype} "
                               f"{tuple(dist.shape)}")
    if row_idx.dtype != torch.int32 or row_idx.dim() != 1:
        require(False, kernel, f"row_idx must be 1-D int32, got {row_idx.dtype} "
                               f"{tuple(row_idx.shape)}")
    if wgt.dtype != torch.float32 or wgt.dim() != 2:
        require(False, kernel, f"wgt must be 2-D float32, got {wgt.dtype} "
                               f"{tuple(wgt.shape)}")
    R, W = wgt.shape
    require(R >= 1, kernel, "the ELL must have at least one row")
    if col.dtype != torch.int32 or col.shape != wgt.shape:
        require(False, kernel, f"col must be int32 of wgt's shape {(R, W)}, got "
                               f"{col.dtype} {tuple(col.shape)}")
    if row_src.dtype != torch.int32 or row_src.shape != (R,):
        require(False, kernel, f"row_src must be int32 ({R},), got "
                               f"{row_src.dtype} {tuple(row_src.shape)}")
    require(max(row_idx.shape[0], R, W) < 2**31, kernel, "sizes exceed int32")


def check_frontier_batch_args(kernel: str, dist, row_idx, count, row_src,
                              col, wgt) -> None:
    """dtypes and shapes of a batched frontier kernel's arguments: S =
    B·P lanes of (dist (S, N), row_idx (S, F), count (S,)) over a
    (row_src (P, R), col and wgt (P, R, W)) ELL, lane s on rank s % P.
    Messages are formatted only on failure: this runs before every
    launch."""
    if dist.dtype != torch.float32 or dist.dim() != 2:
        require(False, kernel, f"dist must be 2-D float32, got {dist.dtype} "
                               f"{tuple(dist.shape)}")
    S = dist.shape[0]
    if row_idx.dtype != torch.int32 or row_idx.dim() != 2 or row_idx.shape[0] != S:
        require(False, kernel, f"row_idx must be int32 ({S}, F), got "
                               f"{row_idx.dtype} {tuple(row_idx.shape)}")
    if count.dtype != torch.int32 or count.shape != (S,):
        require(False, kernel, f"count must be int32 ({S},), got {count.dtype} "
                               f"{tuple(count.shape)}")
    if wgt.dtype != torch.float32 or wgt.dim() != 3:
        require(False, kernel, f"wgt must be 3-D float32, got {wgt.dtype} "
                               f"{tuple(wgt.shape)}")
    P, R, W = wgt.shape
    require(R >= 1, kernel, "the ELL must have at least one row")
    if col.dtype != torch.int32 or col.shape != wgt.shape:
        require(False, kernel, f"col must be int32 of wgt's shape {(P, R, W)}, "
                               f"got {col.dtype} {tuple(col.shape)}")
    if row_src.dtype != torch.int32 or row_src.shape != (P, R):
        require(False, kernel, f"row_src must be int32 ({P}, {R}), got "
                               f"{row_src.dtype} {tuple(row_src.shape)}")
    if S % P:
        require(False, kernel, f"{S} lanes do not cover {P} ranks evenly")
    require(max(S, row_idx.shape[1], R, W, dist.shape[1]) < 2**31, kernel,
            "sizes exceed int32")


def vector_strips(W: int, *tensors: torch.Tensor) -> bool:
    """Whether a frontier kernel may move its (R, W) strips as 16-byte
    vectors: W a multiple of 4 and every tensor's base on 16 bytes (a
    view can start anywhere)."""
    return W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def count_launch(kernel: str, shape: tuple | None = None) -> None:
    """Count one launch of ``kernel``, and one at ``shape`` if given."""
    _launches[kernel] += 1
    if shape is not None:
        _shapes[kernel][shape] = _shapes[kernel].get(shape, 0) + 1


def count_call(kernel: str, route: str) -> None:
    _calls[kernel][route] += 1


@contextlib.contextmanager
def kernel_call(kernel: str, route: str, **shape):
    """Count one call of ``kernel``'s public op on ``route`` and tell
    each listener (an object with ``enter(kernel, route, shape)`` and
    ``exit()``) where it starts and ends; ``shape`` names the sizes of
    the call."""
    _calls[kernel][route] += 1
    for listener in _listeners:
        listener.enter(kernel, route, shape)
    try:
        yield
    finally:
        for listener in reversed(_listeners):
            listener.exit()


def add_listener(listener) -> None:
    _listeners.append(listener)


def remove_listener(listener) -> None:
    _listeners.remove(listener)


def call_counts() -> dict:
    """Calls per kernel's public op and route since the last
    :func:`reset_launch_counts`: ``{kernel: {"cuda": n, "ref": n}}``."""
    return {k: dict(v) for k, v in _calls.items()}


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def launch_shapes() -> dict:
    """Launches per kernel and shape since the last
    :func:`reset_launch_counts`, for the wrappers that count a shape:
    ``{kernel: {shape: n}}``."""
    return {k: dict(v) for k, v in _shapes.items()}


def reset_launch_counts() -> None:
    """Set every launch count and call count to 0."""
    for k in _launches:
        _launches[k] = 0
        _shapes[k] = {}
        _calls[k] = dict.fromkeys(ROUTES, 0)
