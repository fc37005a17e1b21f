"""Synthetic deterministic batches (pure functions of seed and step),
numpy only: the same bytes as the JAX package's ``data/synthetic.py``
for the same arguments."""

from __future__ import annotations

import numpy as np

from repro_torch.models.gnn.batch import flat_batch_from_graph, random_molecule_batch


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_batch(step: int, batch: int, seq: int, vocab: int,
             seed: int = 0) -> dict:
    """Markov-ish token stream: next token depends on the previous one
    so a small LM can actually reduce loss against it."""
    rng = _rng(seed, step)
    base = rng.integers(0, vocab, size=(batch, 1))
    steps = rng.integers(1, 7, size=(batch, seq))
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    toks = np.concatenate([base, toks], axis=1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def mind_batch(step: int, batch: int, cfg, seed: int = 0) -> dict:
    """One MIND batch: history, profile ids (all valid), target and
    sampled negatives; 80% of history slots are valid."""
    rng = _rng(seed, step)
    F = cfg.n_profile_fields * cfg.profile_multi
    return {
        "hist": rng.integers(0, cfg.n_items, (batch, cfg.hist_len)
                             ).astype(np.int32),
        "hist_mask": rng.random((batch, cfg.hist_len)) > 0.2,
        "profile_ids": rng.integers(0, cfg.n_profile, (batch, F)
                                    ).astype(np.int32),
        "profile_mask": np.ones((batch, F), dtype=bool),
        "target": rng.integers(0, cfg.n_items, (batch,)).astype(np.int32),
        "negatives": rng.integers(
            0, cfg.n_items, (batch, cfg.n_negatives)
        ).astype(np.int32),
    }


def gnn_flat_batch(graph, d_feat: int, n_classes: int, *,
                   coords: bool = False, triplets: bool = False,
                   triplet_cap=4, seed: int = 0) -> dict:
    """Synthetic features and labels on ``graph``'s topology, as the
    dict the GNN forward takes (numpy); with ``triplets``, DimeNet's
    lists capped at ``triplet_cap`` a edge."""
    fb = flat_batch_from_graph(graph, d_feat, n_classes, with_coords=coords,
                               with_triplets=triplets, triplet_cap=triplet_cap, seed=seed)
    out = {
        "x": fb.x, "edge_src": fb.edge_src, "edge_dst": fb.edge_dst,
        "edge_mask": fb.edge_mask, "labels": fb.labels,
    }
    if coords:
        out["coords"] = fb.coords
    if triplets:
        out |= {"tri_kj": fb.tri_kj, "tri_ji": fb.tri_ji, "tri_mask": fb.tri_mask}
    return out


def molecule_batch(step: int, batch: int, n_atoms: int, n_edges: int,
                   *, triplets: bool = False, triplet_pad: int = 512,
                   seed: int = 0) -> dict:
    """The packed molecule batch of ``step`` as the dict the molecule
    loss takes (numpy); with ``triplets``, each graph's list in
    ``triplet_pad`` slots."""
    mb = random_molecule_batch(batch, n_atoms, n_edges, seed=seed + 7919 * step,
                               with_triplets=triplets, triplet_pad=triplet_pad)
    out = {
        "x": mb.x, "coords": mb.coords, "edge_src": mb.edge_src,
        "edge_dst": mb.edge_dst, "edge_mask": mb.edge_mask, "y": mb.y,
    }
    if triplets:
        out |= {"tri_kj": mb.tri_kj, "tri_ji": mb.tri_ji, "tri_mask": mb.tri_mask}
    return out
