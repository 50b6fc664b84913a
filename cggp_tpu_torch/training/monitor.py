"""Run monitor: callback registry, TensorBoard scalars and ``.npy`` log dumps
(port of ``cggp_tpu/training/monitor.py``).

Callbacks are registered with a ``record_step`` period and run on the
caller's step; scalar results go to a tensorboardX ``SummaryWriter`` when
tensorboardX is installed (it stays optional), and every callback's results
are flushed to ``{name}.logs.npy``: an object array of dicts holding
``step`` and numpy values, the JAX package's layout, so either package's
log reader reads the other's logs.  Tensor values are copied to the host
when a result is handled.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

try:  # pragma: no cover - depends on the environment
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Monitor:
    """Callback registry with scalar logging.

    Callbacks have signature ``callback(step, params) -> dict | None``, where
    ``params`` is the live parameter dict the training loop passes."""

    def __init__(self, logdir: Optional[str] = None, use_tensorboard: bool = True):
        self.logdir = None if logdir is None else Path(logdir)
        if self.logdir is not None:
            self.logdir.mkdir(parents=True, exist_ok=True)
        self._writer = None
        if use_tensorboard and SummaryWriter is not None and self.logdir is not None:
            self._writer = SummaryWriter(logdir=str(self.logdir))
        self._callbacks: Dict[str, Callable] = {}
        self._record_steps: Dict[str, int] = {}
        self._logs: Dict[str, List[Dict]] = {}

    def add_callback(self, name: str, callback: Callable, record_step: int = 1) -> None:
        """Register ``callback`` to run every ``record_step`` steps."""
        self._callbacks[name] = callback
        self._record_steps[name] = max(int(record_step), 1)
        self._logs.setdefault(name, [])

    def collect_logs(self) -> Dict[str, List[Dict]]:
        return dict(self._logs)

    def _handle_result(self, name: str, step: int, result) -> None:
        if not isinstance(result, dict):
            return
        entry = {"step": step}
        for key, value in result.items():
            value = _to_numpy(value)
            entry[key] = value
            if self._writer is not None and value.ndim == 0:
                self._writer.add_scalar(f"{name}/{key}", float(value), global_step=step)
        self._logs[name].append(entry)

    def __call__(self, step: int, params=None, final: bool = False) -> None:
        """Run all callbacks due at ``step`` (``final=True`` forces all)."""
        for name, callback in self._callbacks.items():
            if final or step % self._record_steps[name] == 0:
                self._handle_result(name, step, callback(step, params))

    def add_scalar(self, tag: str, value, step: int) -> None:
        """Direct scalar write (the trainers' loss and step-time traces),
        kept in the ``.npy`` logs as well under ``tag``'s first part."""
        value = float(value)
        if self._writer is not None:
            self._writer.add_scalar(tag, value, global_step=step)
        name, _, key = tag.partition("/")
        self._logs.setdefault(name, []).append({"step": step, key or "value": np.asarray(value)})

    def flush(self) -> None:
        """Dump the accumulated logs to ``{name}.logs.npy``."""
        if self.logdir is None:
            return
        for name, entries in self._logs.items():
            if entries:
                np.save(str(self.logdir / f"{name}.logs.npy"),
                        np.asarray(entries, dtype=object), allow_pickle=True)
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
