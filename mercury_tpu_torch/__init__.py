"""mercury_tpu_torch — the PyTorch + CUDA port of mercury_tpu for NVIDIA
Hopper (H100).

Mercury's importance-sampled training step (score a candidate pool, draw
the batch by importance, train on the reweighted loss) with hand-written
CUDA kernels for the per-sample NLL (forward and backward) and the fused
score-and-draw. The JAX package ``mercury_tpu`` is the reference the port
is tested against; the port imports nothing from it.

The names below load on first use (PEP 562), so the offline tools that
need the standard library only (``python -m mercury_tpu_torch.obs.report``,
``obs.profile_parse``) run where torch is not installed.
"""

import importlib

_LAZY = {"TrainConfig": "mercury_tpu_torch.config",
         "create_model": "mercury_tpu_torch.models",
         "Trainer": "mercury_tpu_torch.train.trainer"}

__all__ = ["TrainConfig", "Trainer", "create_model"]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
