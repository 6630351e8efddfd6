"""Device milliseconds a step of the optimizers (the dense sweeps and the
fused touched-rows update): the program's span ``train.update``, the
compute stream's time between its two markers
(wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "train.update", "device_s")
