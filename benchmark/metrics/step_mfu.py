"""The whole step's share of the configuration's stated peak, in %: the
model's FLOPs a step (harness/counts.step_flops: the MLP's GEMMs forward
and backward, and the FM term) times the window's steps, over the window's
seconds and the peak (config.json ``peak_flops_per_s``)."""


def read(run):
    c = run.counters
    window = run.spans.get("window")
    if not window or not c.get("window_steps") or not c.get(
            "peak_flops_per_s"):
        return None
    rate = c["flops_per_step"] * c["window_steps"] / window[0]
    return 100.0 * rate / c["peak_flops_per_s"]
