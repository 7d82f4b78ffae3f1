"""Observability of the port (draco_tpu/obs): the real narrow wire's
quantizers and thresholds (``numerics``), the forensics masks, the run
heartbeat, the incident engine (``incidents``) and its offline reader
(``replay``)."""
