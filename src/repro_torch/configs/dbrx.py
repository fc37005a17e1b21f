"""dbrx-132b [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16
fine-grained experts top-4: 131.6 B parameters.  On the card the full
config attends through the flash-attention kernel (head dim 128, 6 q
heads a kv head); its 263 GB of bf16 weights need several cards, so one
card runs it at fewer layers.
"""

from repro_torch.configs.cells import LM_SHAPES, lm_cell
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

ARCH_ID = "dbrx-132b"
FAMILY = "lm"
SHAPES = list(LM_SHAPES)


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(
            name=ARCH_ID + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=96, vocab=211,
            param_dtype="float32", loss_chunk=8,
            moe=MoEConfig(n_experts=4, top_k=4, d_model=64, d_ff=96,
                          capacity_factor=2.0, min_capacity=16),
        )
    return LMConfig(
        name=ARCH_ID, n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab=100352,
        moe=MoEConfig(n_experts=16, top_k=4, d_model=6144, d_ff=10752),
        attn_impl="pallas", attn_chunk=2048,
    )


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    return lm_cell(ARCH_ID, make_config(reduced), cell, ranks)
