"""Models of the port: the dense GQA LM (``lm``) and MIND (``mind``),
their serving paths, and ``convert`` from the JAX package's parameter
trees (as numpy)."""
