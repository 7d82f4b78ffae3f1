"""Observability of the port (draco_tpu/obs): the real narrow wire's
quantizers and thresholds (``numerics``)."""
