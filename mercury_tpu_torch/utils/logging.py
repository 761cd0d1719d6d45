"""Logging of the port: the package's stdlib logger and the synchronous
JSONL metrics logger — the PyTorch counterpart of
``mercury_tpu/utils/logging.py``.

:func:`get_logger` configures one handler on the ``"mercury_tpu_torch"``
root, so every module's lines (and the command line's) share one format.
:class:`MetricsLogger` writes step-keyed scalars to ``metrics.jsonl``
(buffered, flushed every ``flush_every`` records and on close) and to
TensorBoard when ``torch.utils.tensorboard`` imports. The trainer's log
tick uses the non-blocking :class:`mercury_tpu_torch.obs.writer.
AsyncMetricWriter` instead; this class is for scripts that log on their
own thread.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

ROOT = "mercury_tpu_torch"


def get_logger(name: str = ROOT) -> logging.Logger:
    """The package's stdlib logger, configured once on the
    ``"mercury_tpu_torch"`` root (one stream handler, ``asctime name
    levelname message``, INFO, not propagated).

    Call sites use lazy %-style arguments (``log.info("resumed at %d",
    step)``), never f-strings, so a disabled level costs no formatting."""
    logger = logging.getLogger(name)
    root = logging.getLogger(ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger


def _try_tensorboard_writer(log_dir: str):
    """A ``SummaryWriter`` on ``log_dir``, or None where
    ``torch.utils.tensorboard`` does not import (it needs the optional
    ``tensorboard`` package)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None


class MetricsLogger:
    """Step-keyed scalar logger: JSONL always, TensorBoard when available.

    The JSONL file is flushed every ``flush_every`` records and on
    :meth:`close`, not per record. ``close()`` is idempotent, and the
    logger is a context manager::

        with MetricsLogger(log_dir) as logger:
            logger.log_scalars(step, {"train/loss": 0.3})
    """

    def __init__(self, log_dir: Optional[str], enabled: bool = True,
                 flush_every: int = 32) -> None:
        self.enabled = enabled and log_dir is not None
        self.flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        self._tb = None
        self._jsonl = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            self._tb = _try_tensorboard_writer(log_dir)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        """Log a dict of tag → value at ``step`` (tags like ``train/acc``);
        each value is ``float()``-ed here, on the caller's thread."""
        if not self.enabled or self._jsonl is None:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()
        if self._tb is not None:
            for tag, value in scalars.items():
                self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
            self._since_flush = 0
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        """Flush buffered records and close the file. Idempotent."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
