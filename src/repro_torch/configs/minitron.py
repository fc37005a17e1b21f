"""minitron-8b [arXiv:2407.14679] (pruned nemotron).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, squared-ReLU
(2-matrix) MLP: 7.73 B parameters.  On the card the full config
attends through the flash-attention kernel.
"""

from repro_torch.configs.cells import LM_SHAPES, lm_cell
from repro_torch.models.lm import LMConfig

ARCH_ID = "minitron-8b"
FAMILY = "lm"
SHAPES = list(LM_SHAPES)


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(
            name=ARCH_ID + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=241,
            param_dtype="float32", mlp_type="relu2",
        )
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=16384, vocab=256000, mlp_type="relu2",
        attn_impl="pallas", attn_chunk=2048,
    )


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    return lm_cell(ARCH_ID, make_config(reduced), cell, ranks)
