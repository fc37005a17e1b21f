from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "flash_attention_cuda", "mha"]
