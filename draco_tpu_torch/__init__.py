"""draco_tpu_torch — the PyTorch/CUDA port of draco_tpu.

The JAX package ``draco_tpu`` stays the reference; this package runs the
same coded data-parallel training step in PyTorch on one NVIDIA H100, with
the coded-gradient kernels written by hand in CUDA C++ for ``sm_90a``
(``csrc/``, built at first use by ``_build.py``). Module names mirror
``draco_tpu/`` so each counterpart is easy to find.

It imports ``torch`` and ``numpy`` and never ``jax`` or any module of
``draco_tpu``. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises.
"""
