from repro_torch.models.gnn.layers import init_mlp, mlp_apply

__all__ = ["init_mlp", "mlp_apply"]
