"""The step's profiler scopes: the JAX step's ``jax.named_scope`` anchors as
``torch.profiler.record_function`` ranges, open only while a profiler
window captures.

A range names the kernels it launches in a ``torch.profiler`` trace (the
``gpu_user_annotation`` ranges of each stream), which is how
``obs/profile_parse.py`` attributes device time to ``mercury_scoring``,
``mercury_grad_sync``, ``mercury_augmentation``, ``mercury_input_fuse``,
``mercury_optimizer`` and ``mercury_variance_probe``. Opening a range is a
host call of its own (an operator in the profiler's record), so a step
opens none unless :data:`state.capturing` is set: the
:class:`~mercury_tpu_torch.train.profile.ProfilerWindow` sets it while it
captures, and an unprofiled step pays one attribute test a site.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

#: The six scope names of the JAX step, in ``profile_parse.SCOPES``' order
#: (the probe's last).
SCOPE_NAMES = ("mercury_scoring", "mercury_grad_sync", "mercury_augmentation",
               "mercury_input_fuse", "mercury_optimizer", "mercury_variance_probe")

#: ``capturing``: True while a profiler window records (a host bool). One
#: flag for the process, as a ``torch.profiler`` capture records the whole
#: process.
state = SimpleNamespace(capturing=False)

_NULL = contextlib.nullcontext()


def scope(name: str):
    """A ``record_function(name)`` range while a window captures, else a
    shared no-op context."""
    if not state.capturing:
        return _NULL
    from torch.profiler import record_function

    return record_function(name)
