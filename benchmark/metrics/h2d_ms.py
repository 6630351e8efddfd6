"""Device milliseconds a step's packed batch takes to reach the card: the
program's span ``input.h2d.copy``, the copy stream's time between its
two markers around the one host-to-device copy
(wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "input.h2d.copy", "device_s")
