#!/usr/bin/env python3
"""The readings behind the tolerances of ``chip_smoke.py``'s check (c)
in phase 8c, and behind phase 7's choice of reference for the attention
backward, on one NVIDIA GPU.

(c) compares ``lm_loss`` and its gradient at 2 layers of phi3-mini-3.8b
(full width, bf16, B 1 x S 4096) through the kernels against the plain
route (``chip_smoke.route_gaps``).  This script reads that comparison on
``--batches`` sound batches, then on faulty routes made by wrapping the
forward kernel's wrapper as ``FlashAttention`` calls it:

- ``lse + 1e-2``: every row's lse off by 0.01 (P 1% low in the backward);
- ``lse base 2``: lse in base 2, the convention the sm90 kernel keeps
  its running max in;
- ``mask one key late``: the forward's out and lse from a causal mask
  that lets row i see key i + 1 (the kernel still launches, its result
  is replaced).

A tolerance that holds the sound batches and refuses the faults lies
between the two.  Then, at phase 7's case f (B 1, H 32, S 4096, D 96,
bf16, causal), the backward kernel against ``attention_bwd_ref`` built
from the plain lse with the kernel's out, and with the plain out.

    python3 scripts/train_bf16_gaps.py [--batches 4]

Prints the card's name and power limit, one line a reading, and writes
them all to ``chiprun_out/train_bf16_gaps.json``.
"""

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    cs.log(f"kernels built in {K.build().seconds:.2f} s")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # chip_smoke's (c): the first 2 of the 32 layers made from its seed
    cfg = dataclasses.replace(get_arch(cs.TRAIN_ARCH).make_config(), n_layers=cs.TRAIN_LAYERS)
    params = lm.init_tree(torch.Generator(device=dev).manual_seed(cs.SEED), cfg)
    two = {**params, "layers": {k: v[:cs.TRAIN_F32_LAYERS].clone()
                                for k, v in params["layers"].items()}}
    del params
    cs.free_card()
    cfg2 = dataclasses.replace(cfg, n_layers=cs.TRAIN_F32_LAYERS)

    def batch(step):
        return {k: torch.as_tensor(v, device=dev) for k, v in
                lm_batch(step, cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.vocab, seed=cs.SEED).items()}

    forward = ops.flash_attention_cuda

    def lse_offset(q, k, v, *, causal, lse=None):
        out = forward(q, k, v, causal=causal, lse=lse)
        lse.add_(1e-2)
        return out

    def lse_base2(q, k, v, *, causal, lse=None):
        out = forward(q, k, v, causal=causal, lse=lse)
        lse.div_(math.log(2))
        return out

    def mask_late(q, k, v, *, causal, lse=None):
        forward(q, k, v, causal=causal, lse=lse)
        Sq, Sk, G = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k.repeat_interleave(G, dim=1).float()) / q.shape[-1] ** 0.5
        seen = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(Sk - Sq + 1)
        s = torch.where(seen, s, -1e30)
        lse.copy_(torch.logsumexp(s, dim=-1))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p,
                            v.repeat_interleave(G, dim=1).float()).to(q.dtype)

    readings = []

    def read(name, step):
        rel, gaps = cs.route_gaps(two, batch(step), cfg2, name)
        worst = max(gaps, key=gaps.get)
        readings.append(dict(route=name, batch=step, loss_rel=rel, worst_leaf=worst,
                             worst_gap=gaps[worst], gaps=gaps))
        cs.log(f"(c) {name}, batch {step}: loss {rel:.4g} of it; worst leaf {worst} "
               f"{gaps[worst]:.4g} of its max |grad|; "
               f"{', '.join(f'{k} {g:.3g}' for k, g in gaps.items())}")

    for step in range(args.batches):
        read("sound", step)
    for name, fault in (("lse + 1e-2", lse_offset), ("lse base 2", lse_base2),
                        ("mask one key late", mask_late)):
        ops.flash_attention_cuda = fault
        try:
            read(name, 0)
        finally:
            ops.flash_attention_cuda = forward
    sound = [r for r in readings if r["route"] == "sound"]
    faults = [r for r in readings if r["route"] != "sound"]
    cs.log(f"(c) sound: largest loss gap {max(r['loss_rel'] for r in sound):.4g}, largest "
           f"leaf gap {max(r['worst_gap'] for r in sound):.4g}; faults: smallest loss gap "
           f"{min(r['loss_rel'] for r in faults):.4g}, smallest worst-leaf gap "
           f"{min(r['worst_gap'] for r in faults):.4g}")
    del two
    cs.free_card()

    # phase 7's case f: the reference from the plain lse, with the
    # kernel's out or the plain out
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    B, H, S, D = 1, 32, 4096, 96
    q, dout, k, v = (torch.randn((B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    lse = torch.empty((B, H, S), device=dev)
    out = K.flash_attention_cuda(q, k, v, causal=True, lse=lse)
    out_ref, lse_ref = K.attention_lse_ref(q, k, v, causal=True)
    got = K.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=True)
    case_f = dict(lse_gap=float((lse - lse_ref).abs().max()),
                  out_gap=float((out.float() - out_ref.float()).abs().max()))
    for which, o in (("kernel out", out), ("plain out", out_ref)):
        want = K.attention_bwd_ref(q, k, v, o, lse_ref, dout, causal=True)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            gap = (g.float() - w.float()).abs()
            bound = cs.ATTN_BWD_TOL * w.float().abs().max() + cs.ATTN_BWD_BF16_RTOL * w.float().abs()
            case_f[f"{which} {name}"] = dict(
                gap_share=float(gap.max() / w.float().abs().max()),
                over_tol=int((gap > bound).sum()))
        del want
    cs.log(f"phase 7 case f: {json.dumps(case_f)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_bf16_gaps.json").write_text(json.dumps(
        {"card": card, "readings": readings, "case_f": case_f}, indent=1))


if __name__ == "__main__":
    main()
