"""PNG output and exact-resume checkpoints."""
