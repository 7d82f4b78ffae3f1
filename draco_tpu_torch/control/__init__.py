"""The chunked host loop of the port (draco_tpu/control): the engine and
its two clients, the autopilot (``autopilot``) and the decode-on-arrival
``engine.SegmentPipeline``."""
