"""Host milliseconds a step waits for its batch on the card: the program's
span ``input.wait.device``, the step's thread blocked on
DevicePrefetchIterator's queue (wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "input.wait.device", "host_s")
