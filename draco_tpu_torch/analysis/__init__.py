"""Static audit of the port (draco_tpu/analysis): its kernels and its
training steps.

``kernel_audit``  every kernel of ``csrc/*.cu`` against its manifest:
                  registers, local memory, shared memory and resident
                  blocks; launch limits at the largest configuration;
                  coverage of its outputs; compute-sanitizer
``registry``      the ten legs and the Manifest of each
``rules``         one inspected step against its manifest: dtype,
                  host_traffic, in_place, collectives, and on the card
                  constant_bloat and memory_budget
``controls``      seeded-defect steps proving each rule is live
``program_lint``  the driver:
                  ``python -m draco_tpu_torch.analysis.program_lint``
"""
