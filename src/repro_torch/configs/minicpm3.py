"""minicpm3-4b [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448 (padded to 73472), MLA
attention (q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64),
tied embeddings: 4.07 B parameters.  Decode attends in latent space (the
cache holds 288 values a token).  MLA's q/k head dim (96) differs from
its v head dim (64), which the attention kernel does not take, so the
prefill attends by the blockwise path in 8k key chunks (full scores
below 8k keys).
"""

from repro_torch.configs.cells import LM_SHAPES, lm_cell
from repro_torch.models.lm import LMConfig

ARCH_ID = "minicpm3-4b"
FAMILY = "lm"
SHAPES = list(LM_SHAPES)


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(
            name=ARCH_ID + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab=181,
            param_dtype="float32", loss_chunk=8, attn_type="mla",
            q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16, tie_embeddings=True,
        )
    return LMConfig(
        name=ARCH_ID, n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, d_ff=6400, vocab=73472, attn_type="mla",
        q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
        qk_rope_dim=32, v_head_dim=64, tie_embeddings=True,
        attn_impl="xla_flash", attn_chunk=8192,
    )


def make_cell(cell: str, ranks: int = 1, reduced: bool = False):
    return lm_cell(ARCH_ID, make_config(reduced), cell, ranks)
