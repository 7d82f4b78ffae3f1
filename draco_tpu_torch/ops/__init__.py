"""The port's hand-written CUDA kernels behind their wrappers.

``KERNELS`` names every wrapper; each counts its own launches in
``<wrapper>.launches`` (a plain int), which :func:`launch_counts` reads
and :func:`reset_launch_counts` zeroes.
"""

from draco_tpu_torch.ops import coded, decode_kernels

KERNELS = {
    "complex_matmul": coded.complex_matmul,
    "complex_project": coded.complex_project,
    "complex_recombine": coded.complex_recombine,
    "cyclic_locator": decode_kernels.cyclic_locator,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
