"""mind [arXiv:1904.08030].

embed_dim 64, 4 interest capsules, 3 routing iterations,
multi-interest interaction; a 2^20-row item table (about the assigned
10^6) and a 2^17-row profile table.  On the card the full config pools
profile fields through the embedding-bag kernel.
"""

from repro_torch.models.mind import MINDConfig

ARCH_ID = "mind"
FAMILY = "recsys"


def make_config(reduced: bool = False) -> MINDConfig:
    if reduced:
        return MINDConfig(n_items=2000, n_profile=500, hist_len=8,
                          n_negatives=15)
    return MINDConfig(embed_dim=64, n_interests=4, capsule_iters=3,
                      n_items=1 << 20, n_profile=1 << 17,
                      hist_len=50, n_negatives=127, bag_impl="pallas")
