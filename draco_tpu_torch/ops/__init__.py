"""The port's hand-written CUDA kernels behind their wrappers.

``KERNELS`` names every wrapper of the main paths, ``CONTROLS`` the kernel
audit's negative controls (``ops/controls.py``, never on a main path); each
counts its own launches in ``<wrapper>.launches`` (a plain int), which
:func:`launch_counts` reads and :func:`reset_launch_counts` zeroes.
"""

from draco_tpu_torch.ops import coded, controls, decode_kernels, draws
from draco_tpu_torch.ops import flash_attention, numerics, vote

KERNELS = {
    "complex_matmul": coded.complex_matmul,
    "complex_project": coded.complex_project,
    "complex_recombine": coded.complex_recombine,
    "cyclic_locator": decode_kernels.cyclic_locator,
    "cyclic_narrow_recombine": decode_kernels.cyclic_narrow_recombine,
    "approx_decode": decode_kernels.approx_decode,
    "flash_fwd": flash_attention.flash_fwd,
    "flash_dq": flash_attention.flash_dq,
    "flash_dkv": flash_attention.flash_dkv,
    "row_fingerprints": vote.row_fingerprints,
    # the segmented wire's (the layer decode and wire_segments > 1)
    "complex_project_segments": coded.complex_project_segments,
    "complex_recombine_segments": coded.complex_recombine_segments,
    "cyclic_narrow_recombine_segments":
        decode_kernels.cyclic_narrow_recombine_segments,
    "approx_decode_segment": decode_kernels.approx_decode_segment,
    # the reference's threefry stream on the card: the random attack,
    # stochastic rounding's draws, the LM's device tokens
    "random_inject": draws.random_inject,
    "round_draw": draws.round_draw,
    "synthetic_text": draws.synthetic_text,
    # the training step's draws: augmentation, dropout, the vote's salts
    "augment_draws": draws.augment_draws,
    "dropout_keep": draws.dropout_keep,
    "vote_salts": draws.vote_salts,
    # the wire observability's: the numerics observatory's statistics and
    # the ingest check of every coded step
    "stage_stats": numerics.stage_stats,
    "nonfinite_rows": numerics.nonfinite_rows,
}
CONTROLS = {
    "control_mistiled_copy": controls.control_mistiled_copy,
    "control_overlaunch": controls.control_overlaunch,
    "control_spill": controls.control_spill,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in {**KERNELS, **CONTROLS}.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *CONTROLS.values()):
        fn.launches = 0
