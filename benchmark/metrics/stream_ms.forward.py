"""Device milliseconds a step of the model's forward and loss: the
program's span ``train.forward``, the compute stream's time between its
two markers (wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "train.forward", "device_s")
