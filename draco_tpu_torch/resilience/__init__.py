"""The resilience layer (draco_tpu/resilience): the seeded fault plan
(``faults``), the step guard (``guards``), and the host half — prefetch
supervision, the checkpoint walk-back and the graceful stop
(``supervisor``)."""
