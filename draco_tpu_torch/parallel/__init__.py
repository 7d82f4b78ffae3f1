"""The LM route of the port (draco_tpu/parallel): the single-shard
TransformerLM step and its token loop."""
