"""Architecture registry of the port: the configurations ported so far.
Each module exposes ARCH_ID, FAMILY and make_config(reduced) (gin-tu's
also takes the cell); the JAX package's dry-run cells (``make_cell``)
are not ported."""

from repro_torch.configs import gin_tu, mind_cfg, minitron, phi3_mini

_MODULES = [phi3_mini, minitron, mind_cfg, gin_tu]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown or not yet ported arch {arch_id!r} (ROADMAP.md lists "
            f"what is still to port); ported: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]
