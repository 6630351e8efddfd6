"""Host milliseconds a step inside ``Trainer.train_batch`` over the
window: the benchmark's span around each call, summed, over the steps."""


def read(run):
    spans = run.spans.get("train_batch")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
