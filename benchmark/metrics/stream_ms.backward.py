"""Device milliseconds a step of autograd's backward (the gradient GEMMs,
K1's sums of the gathers' gradients): the program's span
``train.backward``, the compute stream's time between its two markers
(wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "train.backward", "device_s")
