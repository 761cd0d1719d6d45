"""Hand-written CUDA kernels of the port, their wrappers and plain versions."""

from mercury_tpu_torch.ops.mercury_kernels import (
    KERNELS,
    augment_normalize,
    launch_counts,
    per_sample_nll,
    reset_launch_counts,
    score_and_draw,
    table_refresh_draw,
)

__all__ = ["KERNELS", "augment_normalize", "launch_counts", "per_sample_nll",
           "reset_launch_counts", "score_and_draw", "table_refresh_draw"]
