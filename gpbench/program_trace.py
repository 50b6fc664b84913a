"""Readers of the program's own spans and counters
(``cggp_tpu_torch.tracing``) for per-layer metrics in ``gpbench/metrics/``.

The harness's profiler turns the program's tracing on for the calls
inside the traced stretch, after set-up's untraced calls, so the
program's latest recording is the stretch's.  A reader returns None for
a program without the module, for a run that recorded nothing, and for
a recording whose calls are not the stretch's (its training steps or
requests counted otherwise than ``ctx.counts``).
"""

from __future__ import annotations

from typing import Dict, Optional

# The span of each unit of ``ctx.counts``: a training step, a request.
UNIT_SPANS = {"steps": "cggp.train.step", "requests": "cggp.serve.predict"}


def summary(ctx, per: str) -> Optional[Dict]:
    """The latest recording's summary, if it holds ``ctx.counts[per]``
    units of the stretch."""
    try:
        from cggp_tpu_torch import tracing
    except ImportError:
        return None
    recording = tracing.latest()
    if recording is None:
        return None
    out = recording.summary()
    count = out["spans"].get(UNIT_SPANS[per], {}).get("count", 0)
    return out if count == ctx.counts[per] > 0 else None


def host_reads(ctx, per: str) -> Optional[float]:
    """Reads of device values on the host per step or request."""
    out = summary(ctx, per)
    return None if out is None else out["host_reads_total"] / ctx.counts[per]


def device_ms(ctx, span: str, per: str) -> Optional[float]:
    """Device milliseconds between the CUDA events of ``span``'s spans,
    per step or request; None where none recorded events (the CPU)."""
    out = summary(ctx, per)
    if out is None or out["spans"].get(span, {}).get("device_ms") is None:
        return None
    return out["spans"][span]["device_ms"] / ctx.counts[per]
