"""The program's own spans (wide_deep_tpu_torch/tracing.py) as the metric
readers take them: a span's field summed over each step, the median over
the steps of the traced stretch's first capture, in ms."""

from __future__ import annotations

import statistics
from typing import Optional


def step_median_ms(run, span: str, field: str) -> Optional[float]:
    """The median a step of span ``span``'s ``field`` (``host_s``,
    ``self_s`` or ``device_s``) over the first ``run.trace.steps`` steps
    that recorded it: those of the capture with the card's activity alone,
    not the host-traced steps after it, whose dispatch the host ops slow.
    None where the run has no trace, nothing was recorded, or the program
    has no spans (before they were added)."""
    if run.trace is None:
        return None
    try:
        from wide_deep_tpu_torch import tracing
    except ImportError:
        return None
    steps = tracing.per_step(tracing.snapshot(), span, field)
    steps = steps[:run.trace.steps]
    return 1e3 * statistics.median(steps) if steps else None
