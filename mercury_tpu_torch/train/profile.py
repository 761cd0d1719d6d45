"""Per-segment timing and the profiler trace — the PyTorch counterpart of
``mercury_tpu/train/profile.py``.

:func:`timing_breakdown` gives the reference's five timed segments of a
step — ``step_time`` (the whole step), ``ff_time`` (the train forward),
``bp_time`` (the backward), ``is_time`` (the importance scoring) and
``sync_time`` (the gradient all-reduce) — plus ``fb_time``, each the
median of ``iters`` timed calls, in seconds. Each segment but the step
runs apart from it, on the trainer's model and its parameters as they
are, leaving them, the running statistics and the gradients untouched:
the sum of the parts need not equal the step. On the card a segment is
timed between two ``torch.cuda.Event``s on the stream (launch gaps
included), on the CPU by the host clock.

:func:`trace` is a ``torch.profiler`` window that writes a Chrome trace.
:class:`ProfilerWindow` is the one an anomaly trigger opens inside
``fit`` (``anomaly_profile_steps``): it writes to
``{anomaly_dir|log_dir}/profile`` and never raises. While it captures, the
step opens its named scopes (``train/scopes.py``), so the trace's kernels
can be attributed (``obs/profile_parse.py``); outside a window the step
opens none.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mercury_tpu_torch.data.pipeline import normalize_images
from mercury_tpu_torch.ops.mercury_kernels import per_sample_nll
from mercury_tpu_torch.parallel.collectives import allreduce_mean_
from mercury_tpu_torch.sampling.importance import per_sample_loss, reweighted_loss
from mercury_tpu_torch.train import scopes
from mercury_tpu_torch.train.step import scoring_forward, to_nchw
from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)


def _timeit(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Median of ``iters`` timed calls of ``fn`` after one untimed call:
    CUDA events around the call on the card, the host clock around the
    call and its completion on the CPU."""
    cuda = device.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(max(int(iters), 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def timing_breakdown(trainer, iters: int = 10) -> Dict[str, float]:
    """The reference's five segments for ``trainer``'s config, and the raw
    forward+backward (seconds, median of ``iters``):

    - ``is_time``: the scoring forward (train-mode, running statistics
      untouched, the scoring precision) and the per-sample loss of the
      pool (the first ``P`` rows of the train split, normalized), through
      the NLL kernel where the step uses it;
    - ``ff_time``: the train forward and per-sample loss of the batch under
      the step's autocast; ``fb_time``: that and the backward of the reweighted loss
      (``torch.autograd.grad``, so no ``.grad`` is written); ``bp_time``:
      ``fb_time − ff_time``, clamped at 0;
    - ``sync_time``: the mean over the ranks of the flat parameters
      (``parallel/collectives.allreduce_mean_`` on a copy), a no-op at one
      rank;
    - ``step_time``: ``trainer.train_step()``, which advances the trainer.
    """
    cfg = trainer.config
    ds = trainer.dataset
    dev = trainer.device
    model = trainer.state.model
    params = [p for p in model.parameters() if p.requires_grad]
    bf16 = cfg.compute_dtype == "bfloat16" and dev.type == "cuda"

    def images_of(n: int):
        idx = np.arange(n) % ds.n_train
        x, y = ds.x_train, ds.y_train
        raw = (torch.from_numpy(np.ascontiguousarray(x[idx])) if isinstance(x, np.ndarray)
               else x[torch.as_tensor(idx, device=x.device)])
        labels = y[torch.as_tensor(idx, device=y.device)]
        return normalize_images(raw.to(dev), ds.mean, ds.std), labels.to(dev)

    pool = images_of(cfg.candidate_pool_size)
    batch = images_of(cfg.batch_size)
    weights = torch.ones(cfg.batch_size, dtype=torch.float32, device=dev)
    smoothing = cfg.label_smoothing

    def loss_of(logits, labels):
        """The step's per-sample loss: the NLL kernel's wrapper, or the
        smoothed loss (whose step runs the plain route)."""
        if smoothing or cfg.use_pallas is False:
            return per_sample_loss(logits, labels, smoothing)
        return per_sample_nll(logits, labels)

    def train_forward(images, labels):
        with torch.autocast(device_type=dev.type, dtype=torch.bfloat16, enabled=bf16):
            logits = model(to_nchw(images), train=True, keep_stats=False)
        return loss_of(logits, labels)

    def score():
        with torch.no_grad():
            return loss_of(scoring_forward(model, pool[0], cfg), pool[1])

    def forward():
        with torch.no_grad():
            return train_forward(*batch)

    def forward_backward():
        loss = reweighted_loss(train_forward(*batch), weights)
        return torch.autograd.grad(loss, params)

    flat = torch.cat([p.detach().reshape(-1) for p in params])

    group = getattr(getattr(trainer, "mesh", None), "data_group", None)

    def sync():
        return allreduce_mean_([flat], group)

    is_t = _timeit(score, iters, dev)
    ff_t = _timeit(forward, iters, dev)
    fb_t = _timeit(forward_backward, iters, dev)
    sync_t = _timeit(sync, iters, dev)
    step_t = _timeit(trainer.train_step, iters, dev)
    return {
        "step_time": step_t,
        "ff_time": ff_t,
        "bp_time": max(fb_t - ff_t, 0.0),
        # The raw forward+backward median: bp_time (fb − ff, clamped) can
        # read 0 from two noisy medians, and fb_time keeps that visible.
        "fb_time": fb_t,
        "is_time": is_t,
        "sync_time": sync_t,
    }


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """A ``torch.profiler`` window (host and, where CUDA is available, the
    card's kernels) whose Chrome trace is written to ``log_dir/name`` when
    the window closes; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


class ProfilerWindow:
    """A ``torch.profiler`` capture of the next few steps of ``fit``, opened
    when the anomaly engine asks for one (the counterpart of the JAX
    Trainer's ``jax.profiler`` window). :meth:`start` opens it for
    ``steps`` steps, :meth:`advance` counts the steps taken and closes it
    after the last, writing ``<log_dir>/profile/trace_step<N>.json`` (N the
    step it opened at). While it is open the step's named scopes open too
    (``scopes.state.capturing``). Nothing here raises: a capture that fails
    to open or to write is logged and dropped. Without ``log_dir`` nothing
    opens."""

    def __init__(self, log_dir: Optional[str]) -> None:
        self.dir = os.path.join(log_dir, "profile") if log_dir else None
        self._prof = None
        self._left = 0
        self._step = 0
        self.written: List[str] = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, steps: int, step: int) -> bool:
        if self.dir is None or self._prof is not None or steps <= 0:
            return False
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as exc:
            _log.warning("profiler start failed: %s", exc)
            return False
        self._prof, self._left, self._step = prof, int(steps), int(step)
        scopes.state.capturing = True
        _log.warning("anomaly-armed profiler capture: %d steps -> %s", steps, self.dir)
        return True

    def advance(self, steps: int = 1) -> Optional[str]:
        """Count ``steps`` steps; after the window's last, close it and
        return the trace's path (None otherwise, or when it failed)."""
        if self._prof is None:
            return None
        self._left -= steps
        if self._left <= 0:
            return self.stop()
        return None

    def stop(self) -> Optional[str]:
        """Close the capture and write its trace; the path, or None."""
        prof, self._prof, self._left = self._prof, None, 0
        if prof is None:
            return None
        scopes.state.capturing = False
        try:
            prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"trace_step{self._step}.json")
            prof.export_chrome_trace(path)
        except Exception as exc:
            _log.warning("profiler stop failed: %s", exc)
            return None
        self.written.append(path)
        return path
