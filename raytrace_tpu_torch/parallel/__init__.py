"""Distribution over torch.distributed (the JAX package's parallel/)."""
