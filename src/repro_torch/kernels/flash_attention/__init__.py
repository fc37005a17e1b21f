from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ops import FlashAttention, mha
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

__all__ = ["FlashAttention", "attention_bwd_ref", "attention_lse_ref", "attention_ref",
           "flash_attention_bwd_cuda", "flash_attention_cuda", "mha"]
