"""mercury_tpu_torch — the PyTorch + CUDA port of mercury_tpu for NVIDIA
Hopper (H100).

Mercury's importance-sampled training step (score a candidate pool, draw
the batch by importance, train on the reweighted loss) with hand-written
CUDA kernels for the per-sample NLL (forward and backward) and the fused
score-and-draw. The JAX package ``mercury_tpu`` is the reference the port
is tested against; the port imports nothing from it.
"""

from mercury_tpu_torch.config import TrainConfig
from mercury_tpu_torch.models import create_model
from mercury_tpu_torch.train.trainer import Trainer

__all__ = ["TrainConfig", "Trainer", "create_model"]
