"""phi3-mini-3.8b [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 = full MHA) d_ff=8192 vocab=32064,
RoPE + SwiGLU.  On the card the full config attends through the
flash-attention kernel.
"""

from repro_torch.configs.cells import LM_SHAPES, lm_cell
from repro_torch.models.lm import LMConfig

ARCH_ID = "phi3-mini-3.8b"
FAMILY = "lm"
SHAPES = list(LM_SHAPES)


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(
            name=ARCH_ID + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab=193,
            param_dtype="float32",
        )
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064,
        attn_impl="pallas", attn_chunk=2048,
    )


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    return lm_cell(ARCH_ID, make_config(reduced), cell, ranks)
