"""Training steps over the renderer (the JAX package's parallel/)."""
