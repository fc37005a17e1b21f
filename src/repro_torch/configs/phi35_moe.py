"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts
top-2: 41.9 B parameters, 6.6 B active a token.  On the card the full
config attends through the flash-attention kernel (head dim 128); its
83.7 GB of bf16 weights do not fit one H100 80 GB, so one card runs it
at fewer layers.
"""

from repro_torch.configs.cells import LM_SHAPES, lm_cell
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"
SHAPES = list(LM_SHAPES)


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(
            name=ARCH_ID + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=96, vocab=199,
            param_dtype="float32", loss_chunk=8,
            moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=96,
                          capacity_factor=2.0, min_capacity=16),
        )
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab=32064,
        moe=MoEConfig(n_experts=16, top_k=2, d_model=4096, d_ff=6400),
        attn_impl="pallas", attn_chunk=2048,
    )


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    return lm_cell(ARCH_ID, make_config(reduced), cell, ranks)
