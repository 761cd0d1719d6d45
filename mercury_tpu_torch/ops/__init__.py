"""Hand-written CUDA kernels of the port, their wrappers and plain versions."""

from mercury_tpu_torch.ops.mercury_kernels import (
    KERNELS,
    launch_counts,
    per_sample_nll,
    reset_launch_counts,
    score_and_draw,
)

__all__ = ["KERNELS", "launch_counts", "per_sample_nll", "reset_launch_counts",
           "score_and_draw"]
