#!/usr/bin/env python3
"""Where the f32 attention backward's time goes: edited copies of
``src/repro_torch/csrc/flash_attention_bwd.cu`` that drop a part of the
3xTF32 arithmetic, timed beside the library's kernels at ``chip_smoke.py``'s
case i (the fp32 twin's train shape: B 1, H 32, S 2048, D 96, causal),
on one NVIDIA GPU.

    python3 scripts/attn_probe.py

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


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
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
        text = SOURCE.read_text()
        for old, new in edits.items():
            if text.count(old) != 1:
                sys.exit(f"{name}: {old!r} is not in {SOURCE.name} exactly once")
            text = text.replace(old, new)
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
