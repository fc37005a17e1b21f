#!/usr/bin/env python3
"""Where the f32 attention backward's time and error go: edited copies
of ``src/repro_torch/csrc/flash_attention_bwd.cu``, on one NVIDIA GPU.

    python3 scripts/attn_probe.py              # time: parts of 3xTF32 dropped
    python3 scripts/attn_probe.py --precision  # error: one product exact at a time

The default mode drops a part of the 3xTF32 arithmetic in each copy and
times it beside the library's kernels at ``chip_smoke.py``'s case i (the
fp32 twin's train shape: B 1, H 32, S 2048, D 96, causal).

``--precision`` takes the two score products (S and dP) each in 3xTF32
on the tensor cores or in f32 FMAs on the CUDA cores, a copy a setting
of ``PRECISION_PROBES``, and for each reports: the worst gap of q, k and v's
gradients to the plain backward in f64 (as a share of max |grad|) at the
shape of ``tests/test_torch_cuda.py::test_lm_train_step_on_card_matches_cpu``
(B 2, Hq 4, Hkv 2, S 128, D 64) and at case i; that test's flow (lm_loss's
gradients and one AdamW step at lr 1e-2, the card against the CPU): each
leaf's worst gradient gap and its params' worst gap after the step, with
the element where that gap is largest, its CPU and card gradients (after
the global-norm clip) beside Adam's eps and the step's lr; and case i's
time alone.

Each of ``PROBES`` is built alone into ``build/attn_ab/`` (as
``scripts/attn_ab.py`` builds its variants) and timed alone under
``torch.profiler`` (twice, each the mean of 20 calls after a write that
evicts L2), with the dK/dV and dQ passes apart.  The edits break the
arithmetic on purpose, so the copies are not held to the plain
backward: each line gives their largest gap to it as a share of max
|grad|, to show how far each is from the gradient.  Prints the card line,
then one JSON line a build.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
# B, Hq, Hkv, S, D: chip_smoke.py's case i, causal
SHAPE = (1, 32, 32, 2048, 96)
_SPLIT = ("  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));",
          "  hi = __float_as_uint(x);\n  lo = 0u;")
_LO_TERMS = {
    "      for (int j = 0; j < kNB; ++j)\n"
    "        mma_tf32(s[j], alo, bhi[j / 2][2 * (j % 2)], bhi[j / 2][2 * (j % 2) + 1]);":
    "      for (int j = 0; j < kNB; ++j) {}",
    "      for (int j = 0; j < kNB; ++j)\n"
    "        mma_tf32(s[j], ahi, bl[j / 2][2 * (j % 2)], bl[j / 2][2 * (j % 2) + 1]);":
    "      for (int j = 0; j < kNB; ++j) {}",
    "      for (int i = 0; i < 4; ++i) mma_tf32(part[i], alo, bhi[i][0], bhi[i][1]);":
    "      for (int i = 0; i < 4; ++i) {}",
    "      for (int i = 0; i < 4; ++i) mma_tf32(part[i], ahi, bl[i][0], bl[i][1]);":
    "      for (int i = 0; i < 4; ++i) {}",
}
#: name -> edits (text of the source -> its replacement)
PROBES = {
    # every operand as it is (lo 0): the three products kept, no split
    "no split arithmetic": dict([_SPLIT]),
    # the hi x hi product alone, the lo terms neither split nor multiplied
    "hi x hi term only": _LO_TERMS,
    # one plain TF32 product a product
    "one TF32 product and no split": {**dict([_SPLIT]), **_LO_TERMS},
}


# the two score products' calls in the dK/dV and the dQ kernel
_S_TF32 = {"    scores_fma<D>(s, kw, qs, lane);": "    scores_tf32<D>(s, kw, hi, lo, lane);",
           "    scores_fma<D>(s, qw, kst, lane);": "    scores_tf32<D>(s, qw, hi, lo, lane);"}
_DP_FMA = {"    scores_tf32<D>(dp, vw, hi + T::kStream, lo + T::kStream, lane);":
           "    scores_fma<D>(dp, vw, dos, lane);",
           "    scores_tf32<D>(dp, dow, hi + T::kStream, lo + T::kStream, lane);":
           "    scores_fma<D>(dp, dow, vst, lane);"}
#: name -> edits (text of the source -> its replacement): S and dP each
#: in 3xTF32 on the tensor cores or in f32 FMAs on the CUDA cores
PRECISION_PROBES = {
    "S in FMAs, dP 3xTF32 (this kernel)": {},
    "S, dP 3xTF32 (PR 30's kernel)": _S_TF32,
    "S 3xTF32, dP in FMAs": {**_S_TF32, **_DP_FMA},
    "S, dP in FMAs": _DP_FMA,
}


def _edited(name: str, edits: dict) -> str:
    text = SOURCE.read_text()
    for old, new in edits.items():
        if text.count(old) != 1:
            sys.exit(f"{name}: {old!r} is not in {SOURCE.name} exactly once")
        text = text.replace(old, new)
    return text


def _build_all(copies: dict) -> dict:
    """name -> source: every copy built at once (one nvcc each), then
    loaded as ``attn_ab.bwd_entry`` loads one."""
    import ctypes

    import attn_ab
    from repro_torch.kernels import _lib

    procs = {}
    for name, src in copies.items():
        out = src.with_suffix(".so")
        procs[name] = (out, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", str(src),
             "-o", str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {name}:\n{log}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)) - {"0"})
        if spills:
            print(f"[{name}] spill stores (bytes): {spills}", flush=True)
        fn = ctypes.CDLL(str(out)).flash_attention_bwd_launch
        fn.argtypes = [_lib.ptr] * 10 + [_lib.c_int] * 8 + [_lib.c_float, _lib.ptr]
        fn.restype = _lib.c_int
        entries[name] = fn
    del attn_ab
    return entries


def _named_leaves(tree: dict) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}.{n}": w for n, w in val.items()})
        else:
            out[key] = val
    return out


def precision() -> None:
    import numpy as np
    import torch

    import attn_ab
    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch import train as T
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import kernel as attn
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    from repro_torch.models import lm
    from repro_torch.models.common import generator
    from repro_torch.train.train_step import value_and_grad

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    K.build()
    attn_ab.CACHE.mkdir(parents=True, exist_ok=True)
    copies = {}
    for i, (name, edits) in enumerate(PRECISION_PROBES.items()):
        copy = attn_ab.CACHE / f"precision_{i}_bwd.cu"
        copy.write_text(_edited(name, edits))
        copies[name] = copy
    entries = _build_all(copies)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # the card test's model, batch and step, its CPU side once
    cfg = lm.LMConfig(name="t", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                      d_ff=512, vocab=512, param_dtype="float32",
                      attn_impl="pallas", loss_chunk=64)
    tc = T.TrainConfig(adamw=T.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=10)
    lr0 = tc.adamw.lr * float(T.warmup_cosine(0, warmup_steps=tc.warmup_steps,
                                              total_steps=tc.total_steps))
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(0, 2, 128, cfg.vocab).items()}
    loss_fn = value_and_grad(lambda p, b: lm.lm_loss(p, b, cfg))
    step = T.build_train_step(lambda p, b: lm.lm_loss(p, b, cfg), tc, donate=True)
    tree = lm.init_tree(generator(0, "cpu"), cfg)
    _, c_grads = loss_fn(tree, batch)
    c_grads = _named_leaves(c_grads)
    c_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in c_grads.values())))
    c_after, _, _ = step(lm.init_tree(generator(0, "cpu"), cfg),
                         T.init_train_state(tree, tc), batch, torch.tensor(0, dtype=torch.int32))
    c_after = _named_leaves(c_after)

    def kernel_gaps(shape, seed):
        # q, k, v, dO as tests/test_torch_cuda.py::attention_grads_case draws them
        B, Hq, Hkv, S, D = shape
        r = np.random.default_rng(seed)
        q, k, v, dout = (torch.as_tensor(r.normal(size=sh).astype(np.float32), device=dev)
                         for sh in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                                    (B, Hq, S, D)))
        lse = torch.empty((B, Hq, S), device=dev)
        out = K.flash_attention_cuda(q, k, v, causal=True, lse=lse)
        o64, l64 = attention_lse_ref(*(t.double().cpu() for t in (q, k, v)), causal=True)
        want = attention_bwd_ref(*(t.double().cpu() for t in (q, k, v)), o64, l64,
                                 dout.double().cpu(), causal=True)
        return (q, k, v, out, lse, dout), want

    def run_kernel(fn, inputs):
        q, k, v, out, lse, dout = inputs
        B, Hq, S, D = q.shape
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((B, Hq, S), device=dev)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(),
                B, Hq, k.shape[1], S, S, D, 0, 1, 1.0 / D ** 0.5,
                torch.cuda.current_stream().cuda_stream)
        return grads, lambda: K._lib.check(fn(*args), "probe")

    # the seed of tests/test_torch_cuda.py::test_flash_attention_bwd_f32_worst_leaf
    test_in, test_want = kernel_gaps((2, 4, 2, 128, 64), 5)
    case_in, case_want = kernel_gaps(SHAPE, chip_smoke.SEED + 1)
    launch_bwd = attn._launch_bwd
    try:
        for name, fn in entries.items():
            line = {"build": name}
            for label, inputs, want in (("test shape", test_in, test_want),
                                        ("case i", case_in, case_want)):
                grads, call = run_kernel(fn, inputs)
                call()
                torch.cuda.synchronize()
                line[f"{label}: gap / max |grad| (dq, dk, dv)"] = [
                    float((g.double().cpu() - w).abs().max() / w.abs().max())
                    for g, w in zip(grads, want)]
            line["case i alone ms"] = round(
                chip_smoke.kernel_alone_ms(call, flush, attn_ab.BWD_NAMES), 4)
            attn._launch_bwd = lambda fn=fn: fn
            card_tree = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
                             else v.to(dev)) for k, v in tree.items()}
            card_batch = {k: v.to(dev) for k, v in batch.items()}
            _, grads = loss_fn(card_tree, card_batch)
            grads = {n: g.cpu() for n, g in _named_leaves(grads).items()}
            line["grad gap / max |grad| by leaf"] = {
                n: float((g - c_grads[n]).abs().max() / c_grads[n].abs().max())
                for n, g in grads.items()}
            after, _, _ = step(card_tree, T.init_train_state(card_tree, tc), card_batch,
                               torch.tensor(0, dtype=torch.int32, device=dev))
            after = {n: w.cpu() for n, w in _named_leaves(after).items()}
            gaps = {n: (w - c_after[n]).abs() for n, w in after.items()}
            worst = max(gaps, key=lambda n: float(gaps[n].max()))
            idx = tuple(int(i) for i in torch.unravel_index(gaps[worst].argmax(),
                                                             gaps[worst].shape))
            g_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
            line["step: worst param gap (atol 1e-3)"] = {
                "leaf": worst, "index": idx, "gap": float(gaps[worst].max()),
                "cpu grad (clipped)": float(c_grads[worst][idx]) * min(1.0, 1.0 / c_norm),
                "card grad (clipped)": float(grads[worst][idx]) * min(1.0, 1.0 / g_norm),
                "adam eps": tc.adamw.eps, "lr at step 0": lr0}
            print(json.dumps(line), flush=True)
    finally:
        attn._launch_bwd = launch_bwd


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--precision", action="store_true",
                        help="error of each setting of the score products, not time")
    if parser.parse_args().precision:
        precision()
        return
    import torch

    import attn_ab
    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as attn

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    K.build()
    entries = {"library": attn._launch_bwd()}
    for name, edits in PROBES.items():
        text = _edited(name, edits)
        stem = "probe_" + re.sub(r"\W+", "_", name)  # nvcc's tools take no commas
        copy = attn_ab.CACHE / f"{stem}_bwd.cu"
        attn_ab.CACHE.mkdir(parents=True, exist_ok=True)
        copy.write_text(text)
        entries[name] = attn_ab.bwd_entry(stem, copy)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1)
    B, Hq, Hkv, S, D = SHAPE
    q, dout = (torch.randn((B, Hq, S, D), generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev) for _ in range(2))
    lse = torch.empty((B, Hq, S), device=dev)
    out = K.flash_attention_cuda(q, k, v, causal=True, lse=lse)
    want = K.attention_bwd_ref(q, k, v, out, lse, dout, causal=True)
    delta = torch.empty((B, Hq, S), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in entries.items():
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(),
                B, Hq, Hkv, S, S, D, 0, 1, 1.0 / D ** 0.5, stream)

        def call(fn=fn, args=args, name=name):
            K._lib.check(fn(*args), name)

        call()
        torch.cuda.synchronize()
        gaps = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(grads, want)]
        print(json.dumps({
            "build": name, "gap / max |grad| (dq, dk, dv)": gaps,
            "alone ms": [round(chip_smoke.kernel_alone_ms(call, flush, attn_ab.BWD_NAMES), 4)
                         for _ in range(2)],
            "alone ms by kernel": attn_ab.kernel_split_ms(
                call, flush, ("attention_delta", "attention_dkdv", "attention_dq")),
        }), flush=True)


if __name__ == "__main__":
    main()
