"""Host utilities of the port (draco_tpu/utils): the metric writers."""
