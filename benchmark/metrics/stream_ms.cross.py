"""Device milliseconds a step of the DCN-V2 cross layers' forward: the
program's span ``train.forward.cross`` (nested in ``train.forward``), the
compute stream's time between its two markers
(wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no such span (before it was added)."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "train.forward.cross", "device_s")
