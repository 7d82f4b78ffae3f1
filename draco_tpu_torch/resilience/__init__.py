"""The host half of the resilience layer (draco_tpu/resilience): prefetch
supervision, the checkpoint walk-back and the graceful stop."""
