"""Host milliseconds a step inside ``Trainer.train_batch``: the program's
span ``train.step`` (wide_deep_tpu_torch/tracing.py).
The median a step over the traced stretch's card-only capture
(harness/spans.py); None where nothing was recorded or the program has
no spans."""

from harness import spans


def read(run):
    return spans.step_median_ms(run, "train.step", "host_s")
