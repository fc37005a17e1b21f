#!/usr/bin/env python3
"""Time the port's f32 flash_attention kernel and its attention backward
(bf16 and f32) against the same kernels built from another source tree, in
turns, in one process on one NVIDIA GPU: the way to hold a change of
``src/repro_torch/csrc/flash_attention.cu`` or
``src/repro_torch/csrc/flash_attention_bwd.cu`` against its parent on
the same card.

    python3 scripts/attn_ab.py PARENT [--only fwd|bwd]

PARENT is a checkout (unpack it with ``git archive``).  Its
``csrc/flash_attention.cu`` and ``csrc/flash_attention_sm90.cu`` are built
alone into ``build/attn_ab/`` with the library's nvcc flags; this tree's
kernel is the library's (``kernels/flash_attention``).  The shapes are
``chip_smoke.py``'s f32 cases of phase 7: case c (B 1, Hq 8, Hkv 2,
Sq 128, Sk 1024, D 128, causal and not: this tree splits its keys) and
case d (the fp32 twin's prefill of phase 8: B 2, Hq 32, Hkv 8, S 2048,
D 128, causal), and the twin's first prefill at S 1920.  For each, both
kernels are held against the plain version (2e-5) and timed as bare
launches in the order parent, change, change, parent, three times over,
by CUDA events after a write that evicts L2 (``chip_smoke.time_ms``)
and alone under ``torch.profiler``; this tree's wrapper, sdpa and the
kernels sdpa ran are timed once.  Each of ``VARIANTS`` (an edited copy
of this tree's ``csrc/flash_attention.cu``, built alone into
``build/attn_ab/``) is checked and timed bare beside them.

The backward (``--only bwd`` alone): PARENT's ``csrc/flash_attention_bwd.cu``
is built alone into ``build/attn_ab/``, and each of ``BWD_VARIANTS`` (an
edited copy of this tree's) likewise; this tree's is the library's.  The
cases are ``chip_smoke.py``'s backward cases of phase 7 (bf16 f:
phi3-mini's train shape, g: G 4, h: G 6; f32 i: the fp32 twin's train
shape).  Each kernel's dq, dk and dv are held against
``attention_bwd_ref`` at phase 7's bounds (1e-4 of max |grad|, bf16 also
one ulp), then timed bare in the order parent, change, variants of the
case's dtype, the same reversed, change, parent, three rounds, and alone
under ``torch.profiler`` (parent, change, change, parent); ``sdpa``'s
backward (``torch.autograd.grad`` of scaled_dot_product_attention, its
forward's graph kept) and this tree's wrapper once.  An f32 case's
bound is its 3xTF32 floor (495 / 3 TFLOP/s), its share of the 67
TFLOP/s CUDA-core bound beside it.  Prints the card line and ptxas's
register and spill report of each backward kernel, then one JSON line a
case.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "attn_ab"
ROUNDS = 3
#: name -> edits (text of csrc/flash_attention.cu -> its replacement)
VARIANTS = {
    "qk unroll 4": {"#pragma unroll 8\n    for (int c = 0; c < D / 4; ++c) {":
                    "#pragma unroll 4\n    for (int c = 0; c < D / 4; ++c) {"},
    "pv unroll 4": {"#pragma unroll 8\n    for (int j = 0; j < kBK; ++j) {":
                    "#pragma unroll 4\n    for (int j = 0; j < kBK; ++j) {"},
}
#: name -> (dtype name of the cases it runs at, edits: text of
#: csrc/flash_attention_bwd.cu -> its replacement)
BWD_VARIANTS = {
    # each gradient summed in one tensor-core accumulator over all the
    # steps, no f32 add of a step's part
    "f32 one sum a gradient": ("float32", {
        "mma_tf32(part[i], alo, bhi[i][0], bhi[i][1]);":
        "mma_tf32(acc[n0 + i], alo, bhi[i][0], bhi[i][1]);",
        "mma_tf32(part[i], ahi, bl[i][0], bl[i][1]);":
        "mma_tf32(acc[n0 + i], ahi, bl[i][0], bl[i][1]);",
        "mma_tf32(part[i], ahi, bhi[i][0], bhi[i][1]);":
        "mma_tf32(acc[n0 + i], ahi, bhi[i][0], bhi[i][1]);",
        "acc[n0 + i][c] += part[i][c];": "part[i][c] = 0.f;"}),
    "f32 scores 4 k8 steps unrolled": ("float32", {
        "constexpr int kUnroll = D > 96 ? 4 : D / 8;": "constexpr int kUnroll = 4;"}),
    # the scores' fragments by 32-bit shared loads, four where one
    # ldmatrix does
    "f32 scores by plain loads": ("float32", {
        "      ldsm_x4(raw, ar + 8 * kk);\n": """      {
        const float* p = a + (lane >> 2) * kLd + 8 * kk + (lane & 3);
        raw[0] = __float_as_uint(p[0]);
        raw[1] = __float_as_uint(p[8 * kLd]);
        raw[2] = __float_as_uint(p[4]);
        raw[3] = __float_as_uint(p[8 * kLd + 4]);
      }
""",
        """        ldsm_x4(bhi[jj], b + bo + 16 * jj * kLd + 8 * kk);
        ldsm_x4(bl[jj], blo + bo + 16 * jj * kLd + 8 * kk);
""": """        const int o = (16 * jj + (lane >> 2)) * kLd + 8 * kk + (lane & 3);
        for (int m = 0; m < 4; ++m) {
          const int om = o + (m & 1) * 4 + (m >> 1) * 8 * kLd;
          bhi[jj][m] = __float_as_uint(b[om]);
          bl[jj][m] = __float_as_uint(blo[om]);
        }
"""}),
}

# calls counted by delta's kernel (one a call), time summed over every
# kernel of the backward's source
BWD_NAMES = ("attention_delta", "attention_")
# label, B, Hq, Hkv, Sq, Sk, D, causal
CASES = (
    ("c causal", 1, 8, 2, 128, 1024, 128, True),
    ("c non-causal", 1, 8, 2, 128, 1024, 128, False),
    ("d fp32 twin prefill", 2, 32, 8, 2048, 2048, 128, True),
    ("fp32 twin prefill at 1920", 2, 32, 8, 1920, 1920, 128, True),
)


def attention_entry(name: str, source: Path, sm90: Path):
    """``flash_attention_launch`` of ``source`` built alone beside
    ``sm90`` (the bf16 kernel it calls), whether it takes (n_split,
    scratch) and whether it takes the nullable lse output; ptxas's
    register report printed."""
    from repro_torch.kernels import _lib

    CACHE.mkdir(parents=True, exist_ok=True)
    stem = "_".join(name.split())
    out = CACHE / f"lib{stem}.so"
    done = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(source),
                           str(sm90), "-o", str(out)], capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {source} ({name}):\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if ("registers" in line or "spill" in line) and "sm90" not in line:
            print(f"[{name}] {line.strip()}", flush=True)
    text = source.read_text()
    split, lse = "n_split" in text, "float* lse" in text
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.argtypes = ([_lib.ptr] * (5 if lse else 4) + [_lib.c_int] * 8 + [_lib.c_float]
                   + ([_lib.c_int, _lib.ptr] if split else []) + [_lib.ptr])
    fn.restype = _lib.c_int
    return fn, split, lse


def bwd_entry(name: str, source: Path):
    """``flash_attention_bwd_launch`` of ``source`` built alone (its own
    directory and this tree's ``csrc`` on the include path); ptxas's
    register and spill report for its bf16 kernels printed."""
    from repro_torch.kernels import _lib

    CACHE.mkdir(parents=True, exist_ok=True)
    out = CACHE / f"lib{'_'.join(name.split())}_bwd.so"
    done = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(source.parent),
                           "-I", str(_lib.CSRC), "-shared", str(source), "-o", str(out)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {source} ({name}):\n{done.stdout}{done.stderr}")
    lines = (done.stdout + done.stderr).splitlines()
    for i, line in enumerate(lines):
        kernel = re.search(r"\d(attention_\w+?_kernel)I(?:Li(\d+)E|(f)E|(13__nv_bfloat16)E)", line)
        if "Compiling entry" in line and kernel:
            tail = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", tail)
            print(f"[{name}] {kernel.group(1)}<{kernel.group(2) or kernel.group(3) or 'bf16'}>: "
                  f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
                  f"{'/'.join(spills.groups()) if spills else '?'}", flush=True)
        if "C7512" in line:
            print(f"[{name}] {line.strip()[:160]}", flush=True)
    fn = ctypes.CDLL(str(out)).flash_attention_bwd_launch
    fn.argtypes = [_lib.ptr] * 10 + [_lib.c_int] * 8 + [_lib.c_float, _lib.ptr]
    fn.restype = _lib.c_int
    return fn


def kernel_split_ms(fn, flush, names) -> dict:
    """Device ms a call of ``fn`` spends in each kernel whose name holds
    one of ``names``, under one profiler window of TIMING_REPS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chip_smoke.TIMING_REPS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                split[name] = round(split.get(name, 0.0) + e.self_device_time_total / 1e3
                                    / chip_smoke.TIMING_REPS, 4)
    return split


def backward_cases(parent_tree: Path, dev, flush) -> None:
    """The backward's A/B (see the module's note)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as attn
    from repro_torch.roofline import BF16_OPS_PER_S, F32_OPS_PER_S, TF32X3_OPS_PER_S, bound
    from repro_torch.roofline.kernels import flash_attention_bwd_traffic

    entries = {"parent": bwd_entry("parent", parent_tree / "src" / "repro_torch" / "csrc"
                                   / "flash_attention_bwd.cu")}
    own = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
    for name, (_, edits) in BWD_VARIANTS.items():
        text = own.read_text()
        for old, new in edits.items():
            if text.count(old) != 1:
                sys.exit(f"{name}: {old!r} is not in {own.name} exactly once")
            text = text.replace(old, new)
        copy = CACHE / f"{'_'.join(name.split())}_bwd.cu"
        CACHE.mkdir(parents=True, exist_ok=True)
        copy.write_text(text)
        entries[name] = bwd_entry(name, copy)
    entries["change"] = attn._launch_bwd()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    for label, B, Hq, Hkv, S, D, dtype_name, causal in chip_smoke.ATTN_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, dout = (torch.randn((B, Hq, S, D), generator=gen, device=dev).to(dtype)
                   for _ in range(2))
        k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        variants = [name for name, (dt, _) in BWD_VARIANTS.items() if dt == dtype_name]
        names = ["parent", "change", *variants]
        lse = torch.empty((B, Hq, S), device=dev)
        out = K.flash_attention_cuda(q, k, v, causal=causal, lse=lse)
        # room for every scratch layout the trees have used: delta, or
        # delta, an f32 dQ and a counter a 64-row q tile
        scratch = torch.empty(B * Hq * S * (D + 2) + 1, device=dev)
        grads = {name: tuple(torch.empty_like(t) for t in (q, k, v)) for name in names}
        head = (B, Hq, Hkv, S, S, D, int(dtype == torch.bfloat16), int(causal), 1.0 / D ** 0.5)

        def bare(name):
            fn = entries[name]
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), *(g.data_ptr() for g in grads[name]), scratch.data_ptr(),
                    *head, stream)
            return lambda: K._lib.check(fn(*args), name)

        calls = {name: bare(name) for name in names}
        want = K.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
        result = {"case": label, "shape": [B, Hq, Hkv, S, D], "causal": causal}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            err = share = 0.0
            for gname, g, w in zip(("dq", "dk", "dv"), grads[name], want):
                gap = (g.float() - w.float()).abs()
                err = max(err, float(gap.max()))
                top = float(w.float().abs().max())
                share = max(share, float(gap.max()) / top)
                rtol = chip_smoke.ATTN_BWD_BF16_RTOL if dtype == torch.bfloat16 else 0.0
                bound_ = chip_smoke.ATTN_BWD_TOL * top + rtol * w.float().abs()
                if bool((gap > bound_).any()):
                    sys.exit(f"{label}: the {name} kernel's {gname} differs from the plain "
                             f"backward (max abs err {float(gap.max())})")
            result[f"{name} max abs err"] = err
            result[f"{name} max abs err / max |grad|"] = share
        turns = ["parent", "change", *variants, *reversed(variants), "change", "parent"]
        for _ in range(ROUNDS):
            for name in turns:
                result.setdefault(f"{name} ms", []).append(
                    round(chip_smoke.time_ms(calls[name], flush), 4))
        for name in ("parent", "change", "change", "parent"):
            result.setdefault(f"{name} alone ms", []).append(round(
                chip_smoke.kernel_alone_ms(calls[name], flush, BWD_NAMES), 4))
        result["change alone ms by kernel"] = kernel_split_ms(
            calls["change"], flush, ("attention_delta", "attention_dkdv", "attention_dq"))
        result["change wrapper ms"] = round(chip_smoke.time_ms(
            lambda: K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal),
            flush), 4)
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*ins, is_causal=causal, enable_gqa=True)

        def library():
            return torch.autograd.grad(lib_out, ins, dout, retain_graph=True)

        result["sdpa backward ms"] = round(chip_smoke.time_ms(library, flush), 4)
        nbytes, flops = flash_attention_bwd_traffic(B, Hq, Hkv, S, S, D, causal,
                                                    q.element_size())
        bf16 = dtype == torch.bfloat16
        bound_ms, bound_by = bound(nbytes, flops, BF16_OPS_PER_S if bf16 else TF32X3_OPS_PER_S)
        result.update(flop=flops, bound_ms=round(bound_ms, 4), bound_by=bound_by)
        cores_ms = None if bf16 else bound(nbytes, flops, F32_OPS_PER_S)[0]
        if cores_ms is not None:
            result["CUDA-core bound ms"] = round(cores_ms, 4)
        for name in ("parent", "change"):
            best = min(result[f"{name} alone ms"])
            result[f"{name} TFLOP/s (alone, best)"] = round(flops / best / 1e9, 2)
            result[f"{name} share of bound (alone, best)"] = round(bound_ms / best, 4)
            if cores_ms is not None:
                result[f"{name} share of the CUDA-core bound (alone, best)"] = round(
                    cores_ms / best, 4)
        print(json.dumps(result), flush=True)
        del q, k, v, dout, out, lse, scratch, grads, calls, want, ins, lib_out


def main() -> None:
    args = sys.argv[1:]
    only = None
    if len(args) == 3 and args[1] == "--only" and args[2] in ("fwd", "bwd"):
        only = args[2]
        args = args[:1]
    if len(args) != 1:
        sys.exit(__doc__)
    parent_tree = Path(args[0]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as attn
    from repro_torch.roofline import bound
    from repro_torch.roofline.kernels import flash_attention_traffic

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    K.build()
    if only != "fwd":
        backward_cases(parent_tree, dev, torch.empty(64 << 20, dtype=torch.uint8, device=dev))
        if only == "bwd":
            return
    csrc = parent_tree / "src" / "repro_torch" / "csrc"
    entries = {"parent": attention_entry("parent", csrc / "flash_attention.cu",
                                         csrc / "flash_attention_sm90.cu")}
    own = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    for name, edits in VARIANTS.items():
        text = own.read_text()
        for old, new in edits.items():
            if text.count(old) != 1:
                sys.exit(f"{name}: {old!r} is not in {own.name} exactly once")
            text = text.replace(old, new)
        copy = CACHE / f"{'_'.join(name.split())}.cu"
        CACHE.mkdir(parents=True, exist_ok=True)
        copy.write_text(text)
        entries[name] = attention_entry(name, copy, own.parent / "flash_attention_sm90.cu")
    entries["change"] = (attn._launch(), True, True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, B, Hq, Hkv, Sq, Sk, D, causal in CASES:
        q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev)
        k = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev)
        v = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev)
        n_split = attn.split_plan(B, Hq, Sq, Sk, causal, sms)
        part = torch.empty(max(1, n_split * B * Hq * Sq * (D + 2)), device=dev)
        outs = {name: torch.empty_like(q) for name in entries}
        head = (B, Hq, Hkv, Sq, Sk, D, 0, int(causal), 1.0 / D ** 0.5)

        def bare(name):
            fn, split, lse = entries[name]
            extra = (n_split, part.data_ptr()) if split else ()
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[name].data_ptr(),
                    *((None,) if lse else ()), *head, *extra, stream)
            return lambda: K._lib.check(fn(*args), name)

        calls = {name: bare(name) for name in outs}
        ref = K.attention_ref(q, k, v, causal=causal)
        result = {"case": label, "shape": [B, Hq, Hkv, Sq, Sk, D], "causal": causal,
                  "n_split": n_split}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            err = float((outs[name] - ref).abs().max())
            if not torch.allclose(outs[name], ref, rtol=2e-5, atol=2e-5):
                sys.exit(f"{label}: the {name} kernel differs from the plain version "
                         f"(max abs err {err})")
            result[f"{name} max abs err"] = err
        turns = ["parent", "change", *VARIANTS, *reversed(VARIANTS), "change", "parent"]
        for _ in range(ROUNDS):
            for name in turns:
                result.setdefault(f"{name} ms", []).append(
                    round(chip_smoke.time_ms(calls[name], flush), 4))
        for name in ("parent", "change", "change", "parent"):
            result.setdefault(f"{name} alone ms", []).append(round(
                chip_smoke.kernel_alone_ms(calls[name], flush,
                                           ("flash_attention_kernel", "flash_merge_kernel")),
                4))
        result["change wrapper ms"] = round(chip_smoke.time_ms(
            lambda: K.flash_attention_cuda(q, k, v, causal=causal), flush), 4)
        mask = None
        if causal and Sq != Sk:  # torch aligns a causal mask top-left
            mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev).tril(Sk - Sq)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        result["sdpa ms"] = round(chip_smoke.time_ms(library, flush), 4)
        result["sdpa kernels"] = chip_smoke.library_kernels(library)
        nbytes, flops = flash_attention_traffic(B, Hq, Hkv, Sq, Sk, D, causal, 4)
        bound_ms, bound_by = bound(nbytes, flops)
        result.update(flop=flops, bound_ms=round(bound_ms, 4), bound_by=bound_by)
        for name in ("parent", "change"):
            best = min(result[f"{name} ms"])
            result[f"{name} TFLOP/s (best)"] = round(flops / best / 1e9, 2)
            result[f"{name} share of bound (best)"] = round(bound_ms / best, 4)
        print(json.dumps(result), flush=True)
        del q, k, v, part, outs, ref, calls


if __name__ == "__main__":
    main()
