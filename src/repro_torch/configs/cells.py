"""Cell shapes of the JAX package's ``configs/cells.py`` that the port
uses: only ``GNN_SHAPES`` so far (that module imports JAX and the
training stack, so the port keeps its own copy)."""

GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, classes=7),
    "minibatch_lg": dict(
        seeds=1024, fanouts=(15, 10), d_feat=602, classes=41,
        n=169984, e=168960,  # padded block sizes for the fanout
    ),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, classes=47),
    "molecule": dict(batch=128, n=30, e=64, d_feat=10, triplet_pad=512),
}
