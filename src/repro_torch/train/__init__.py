"""The training step factory."""
