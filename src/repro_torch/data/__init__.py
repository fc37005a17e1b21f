from repro_torch.data.synthetic import gnn_flat_batch, lm_batch, mind_batch, molecule_batch

__all__ = ["gnn_flat_batch", "lm_batch", "mind_batch", "molecule_batch"]
