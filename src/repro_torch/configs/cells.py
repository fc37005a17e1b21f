"""Cell plans: an (architecture × input-shape) cell as the shapes and
dtypes of its arguments plus its useful-FLOPs formula.

The JAX package's ``configs/cells.py`` builds a ``CellProgram``: a
jittable function with abstract inputs and shardings, which its
dry-run lowers and compiles on a 512-device mesh.  The port runs
eagerly and compiles nothing, so a :class:`CellPlan` keeps what can be
known without running: its arguments as meta-device tensors (shape and
dtype, no data) in the JAX package's layout, ``model_flops`` by the
same formulas, and the rank count it is planned for.  It has no
shardings and nothing to lower; ``launch/dryrun.py`` reads its bytes
and, for SSSP cells, plans one superstep's peak memory from its shape.

The JAX package's ``lm_cell(probe_layers=)`` (and each LM config's
``make_cell`` argument of that name) builds depth-1 and depth-2
unrolled probes only to correct XLA's cost analysis, which counts a
scanned layer once; the port neither scans nor compiles, so it has no
counterpart.

The port shards no model over cards (``ROADMAP.md`` Queue 1 item 5.6):
an LM or MIND plan's arguments are the whole model and batch, whatever
its rank count.  An SSSP plan's arguments are stacked over its ranks,
one row of each a rank.  Train cells wait for training (Queue 1 item
5) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.api.config import SolverConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.mind import MINDConfig


@dataclasses.dataclass
class CellPlan:
    arch: str
    cell: str
    kind: str                      # prefill | decode | serve | sssp
    args: tuple                    # pytrees of meta tensors
    model_flops: float = 0.0       # useful FLOPs per execution
    notes: str = ""
    ranks: int = 1                 # the rank count it is planned for
    # SSSP only: the solver configuration and the partition's shape
    # (n_parts, n_local, rows, width) the arguments were made from
    config: Optional[SolverConfig] = None
    shape: Optional[dict] = None

    @property
    def arg_bytes(self) -> int:
        """Bytes of every argument, exact from the shapes and dtypes."""
        return sum(t.numel() * t.element_size() for t in tree_leaves(self.args))


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_unported(arch: str, cell: str, item: str):
    raise NotImplementedError(
        f"{arch} cell {cell!r} is a train cell: training is not ported yet "
        f"(ROADMAP.md Queue 1 item {item})")


# ------------------------------------------------------------------ #
# LM cells

#: the ROADMAP.md item that brings each family's train cells
TRAIN_ITEMS = {"lm": "5.4 (lm_loss and LM training)",
               "gnn": "5.1 (GIN training)",
               "recsys": "5.5 (MIND training)"}


def lm_flops_train(cfg: lm_mod.LMConfig, B: int, S: int) -> float:
    """6·N_active·tokens + attention score/value terms (fwd+bwd)."""
    n = cfg.n_active_params()
    attn = 12 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
    return 6.0 * n * B * S + attn


def lm_flops_prefill(cfg: lm_mod.LMConfig, B: int, S: int) -> float:
    n = cfg.n_active_params()
    attn = 2 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
    return 2.0 * n * B * S + attn


def lm_flops_decode(cfg: lm_mod.LMConfig, B: int, S_ctx: int) -> float:
    n = cfg.n_active_params()
    attn = 4 * cfg.n_layers * B * S_ctx * cfg.n_heads * cfg.head_dim
    return 2.0 * n * B + attn


def lm_param_shapes(cfg: lm_mod.LMConfig) -> dict:
    """The parameters as meta tensors in the JAX package's layout
    (``layers`` stacked over a leading layer axis); the port's ``LM``
    holds the same tensors a layer at a time."""
    L, dt = cfg.n_layers, cfg.dtype
    return {
        "embed": meta((cfg.vocab, cfg.d_model), dt),
        "layers": {name: meta((L,) + shape, dt)
                   for name, (shape, _) in lm_mod.layer_shapes(cfg).items()},
        "final_norm": meta((cfg.d_model,), dt),
        "lm_head": meta((cfg.d_model, cfg.vocab), dt),
    }


def lm_prefill_cell(arch: str, cell: str, cfg: lm_mod.LMConfig, ranks: int,
                    B: int, S: int) -> CellPlan:
    return CellPlan(
        arch=arch, cell=cell, kind="prefill",
        args=(lm_param_shapes(cfg), meta((B, S), torch.int32)),
        model_flops=lm_flops_prefill(cfg, B, S),
        notes=f"B={B} S={S}", ranks=ranks,
    )


def lm_decode_cell(arch: str, cell: str, cfg: lm_mod.LMConfig, ranks: int,
                   B: int, S_ctx: int, long: bool) -> CellPlan:
    return CellPlan(
        arch=arch, cell=cell, kind="decode",
        args=(lm_param_shapes(cfg), lm_mod.cache_shapes(cfg, B, S_ctx),
              meta((B,), torch.int32), meta((), torch.int32)),
        model_flops=lm_flops_decode(cfg, B, S_ctx),
        notes=f"B={B} S_ctx={S_ctx}" + (" SP-decode" if long else ""),
        ranks=ranks,
    )


# LM shape cells shared by all five assigned transformer archs
LM_SHAPES = {
    "train_4k": dict(kind="train", S=4096, B=256),
    "prefill_32k": dict(kind="prefill", S=32768, B=32),
    "decode_32k": dict(kind="decode", S=32768, B=128),
    "long_500k": dict(kind="decode", S=524288, B=1, long=True),
}


def lm_cell(arch: str, cfg: lm_mod.LMConfig, cell: str,
            ranks: int = 1) -> CellPlan:
    sh = LM_SHAPES[cell]
    if sh["kind"] == "train":
        train_unported(arch, cell, TRAIN_ITEMS["lm"])
    if sh["kind"] == "prefill":
        return lm_prefill_cell(arch, cell, cfg, ranks, sh["B"], sh["S"])
    return lm_decode_cell(arch, cell, cfg, ranks, sh["B"], sh["S"],
                          sh.get("long", False))


# ------------------------------------------------------------------ #
# GNN cells

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, classes=7),
    "minibatch_lg": dict(
        seeds=1024, fanouts=(15, 10), d_feat=602, classes=41,
        n=169984, e=168960,  # padded block sizes for the fanout
    ),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, classes=47),
    "molecule": dict(batch=128, n=30, e=64, d_feat=10, triplet_pad=512),
}


_PAD = 512  # lcm of the JAX package's two production meshes' device counts


def _pad_up(x: int, m: int = _PAD) -> int:
    return -(-x // m) * m


def gnn_flat_batch_shapes(sh: dict, *, coords: bool, triplets: bool,
                          tri_cap: int = 2) -> dict:
    """Node/edge/triplet counts padded up to a multiple of 512, as the
    JAX package pads them for even shards; padded entries carry
    mask=False."""
    n, e = _pad_up(sh["n"]), _pad_up(sh["e"])
    batch = {
        "x": meta((n, sh["d_feat"]), torch.float32),
        "edge_src": meta((e,), torch.int32),
        "edge_dst": meta((e,), torch.int32),
        "edge_mask": meta((e,), torch.bool),
        "labels": meta((n,), torch.int32),
    }
    if coords:
        batch["coords"] = meta((n, 3), torch.float32)
    if triplets:
        t = _pad_up(e * tri_cap)
        batch["tri_kj"] = meta((t,), torch.int32)
        batch["tri_ji"] = meta((t,), torch.int32)
        batch["tri_mask"] = meta((t,), torch.bool)
    return batch


def gnn_packed_batch_shapes(sh: dict, *, triplets: bool) -> dict:
    b, n, e = sh["batch"], sh["n"], sh["e"]
    batch = {
        "x": meta((b, n, sh["d_feat"]), torch.float32),
        "coords": meta((b, n, 3), torch.float32),
        "edge_src": meta((b, e), torch.int32),
        "edge_dst": meta((b, e), torch.int32),
        "edge_mask": meta((b, e), torch.bool),
        "y": meta((b,), torch.float32),
    }
    if triplets:
        t = sh["triplet_pad"]
        batch["tri_kj"] = meta((b, t), torch.int32)
        batch["tri_ji"] = meta((b, t), torch.int32)
        batch["tri_mask"] = meta((b, t), torch.bool)
    return batch


# ------------------------------------------------------------------ #
# recsys (MIND) cells

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", B=65536),
    "serve_p99": dict(kind="serve", B=512),
    "serve_bulk": dict(kind="serve", B=262144),
    "retrieval_cand": dict(kind="retrieval", B=1, n_candidates=1_000_000),
}


def mind_param_shapes(cfg: MINDConfig) -> dict:
    d = cfg.embed_dim
    f32 = torch.float32
    return {
        "item_table": meta((cfg.n_items, d), f32),
        "profile_table": meta((cfg.n_profile, d), f32),
        "bilinear": meta((d, d), f32),
        "routing_init": meta((cfg.n_interests,), f32),
        "interest_mlp": {"w0": meta((2 * d, d), f32), "b0": meta((d,), f32),
                         "w1": meta((d, d), f32), "b1": meta((d,), f32)},
    }


def mind_batch_shapes(cfg: MINDConfig, B: int, *, with_labels: bool) -> dict:
    F = cfg.n_profile_fields * cfg.profile_multi
    batch = {
        "hist": meta((B, cfg.hist_len), torch.int32),
        "hist_mask": meta((B, cfg.hist_len), torch.bool),
        "profile_ids": meta((B, F), torch.int32),
        "profile_mask": meta((B, F), torch.bool),
    }
    if with_labels:
        batch["target"] = meta((B,), torch.int32)
        batch["negatives"] = meta((B, cfg.n_negatives), torch.int32)
    return batch


def mind_flops(cfg: MINDConfig, B: int, kind: str, n_candidates: int = 0) -> float:
    d, K, L = cfg.embed_dim, cfg.n_interests, cfg.hist_len
    routing = 2 * cfg.capsule_iters * 2 * B * L * K * d + 2 * B * L * d * d
    mlp = 2 * B * K * (2 * d * d + d * d)
    fwd = routing + mlp
    if kind == "train":
        return 3 * fwd + 6 * B * (1 + cfg.n_negatives) * d
    if kind == "retrieval":
        return fwd + 2 * B * K * n_candidates * d
    return fwd


def mind_cell(arch: str, cell: str, cfg: MINDConfig, ranks: int = 1) -> CellPlan:
    sh = RECSYS_SHAPES[cell]
    B = sh["B"]
    if sh["kind"] == "train":
        train_unported(arch, cell, TRAIN_ITEMS["recsys"])
    params = mind_param_shapes(cfg)
    batch = mind_batch_shapes(cfg, B, with_labels=False)
    if sh["kind"] == "retrieval":
        nc = sh["n_candidates"]
        return CellPlan(
            arch=arch, cell=cell, kind="serve",
            args=(params, batch, meta((nc,), torch.int32)),
            model_flops=float(mind_flops(cfg, B, "retrieval", nc)),
            notes=f"B={B} n_candidates={nc}", ranks=ranks,
        )
    return CellPlan(
        arch=arch, cell=cell, kind="serve", args=(params, batch),
        model_flops=float(mind_flops(cfg, B, "serve")), notes=f"B={B}",
        ranks=ranks,
    )


# ------------------------------------------------------------------ #
# SSSP (the paper's own workload) cells


def sssp_rows(n_local: int, avg_degree: int, width: int) -> int:
    """Virtual ELL rows a rank, planned without building the graph:
    ceil(deg/width) summed is about e/width + n_local, with a safety
    factor of 1.3 (the JAX package's formula)."""
    return int(1.3 * (n_local * avg_degree / width + n_local))


def sssp_args(n_parts: int, n_local: int, rows: int, width: int) -> tuple:
    """The engine's arguments as the JAX package passes them: the
    stacked ELL (row_src, col, wgt) and the (D, T, L) state planes with
    each rank's dummy slot."""
    return (
        meta((n_parts, rows), torch.int32),
        meta((n_parts, rows, width), torch.int32),
        meta((n_parts, rows, width), torch.float32),
        meta((n_parts, n_local + 1), torch.float32),
        meta((n_parts, n_local + 1), torch.float32),
        meta((n_parts, n_local + 1), torch.float32),
    )


def sssp_plan(arch: str, cell: str, config: SolverConfig, *, n_parts: int,
              n_local: int, rows: int, width: int, model_flops: float = 0.0,
              notes: str = "") -> CellPlan:
    """An SSSP plan at a given partition shape (a real partition's, or
    the one :func:`sssp_cell` reckons)."""
    return CellPlan(
        arch=arch, cell=cell, kind="sssp",
        args=sssp_args(n_parts, n_local, rows, width),
        model_flops=model_flops, notes=notes, ranks=n_parts, config=config,
        shape=dict(n_parts=n_parts, n_local=n_local, rows=rows, width=width),
    )


def sssp_cell(arch: str, cell: str, ranks: int = 1, *,
              scale: int, avg_degree: int, width: int,
              root: str = "delta:5", variant: str = "buffer",
              exchange: str = "a2a", spec: "str | None" = None) -> CellPlan:
    """A partitioned-graph SSSP solve over ``ranks`` ranks, planned from
    (scale, avg_degree, width) without building the graph.  ``spec``
    (any solver spec) overrides root/variant/exchange."""
    n = 1 << scale
    n_local = -(-n // ranks)
    cfg = (
        SolverConfig.from_spec(spec, chunk_size=4096)
        if spec is not None
        else SolverConfig(root=root, variant=variant, exchange=exchange,
                          chunk_size=4096)
    )
    # per-superstep useful flops: relax (2 flops/edge) + scatter+min
    flops_per_step = 3.0 * n * avg_degree / 1.0
    return sssp_plan(
        arch, cell, cfg, n_parts=ranks, n_local=n_local,
        rows=sssp_rows(n_local, avg_degree, width), width=width,
        model_flops=flops_per_step,
        notes=(f"scale={scale} deg={avg_degree} W={width} "
               f"{cfg.name} (flops = one superstep)"),
    )
