"""Models of the port: the dense GQA LM (``lm``), MIND (``mind``) and
GIN inference (``gnn.gin``), their serving paths, and ``convert`` from
the JAX package's parameter trees (as numpy)."""
