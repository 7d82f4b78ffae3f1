"""The training step and loop (draco_tpu/training)."""
