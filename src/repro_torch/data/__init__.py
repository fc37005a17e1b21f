from repro_torch.data.synthetic import lm_batch, mind_batch

__all__ = ["lm_batch", "mind_batch"]
