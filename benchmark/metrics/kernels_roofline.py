"""The step's sparse-gradient work against its roofline, in %: the least
time the card could take for it (harness/counts.grad_work: the batch's own
ids and gradient entries read once, each distinct touched row read and
written once, over 3.35 TB/s or 67 TFLOP/s), over the device time of every
kernel the classifier of harness/trace.py gives that work (the port's K1,
K2 and K3, the library's scatter, index-add and sort kernels, memsets)."""


def read(run):
    bound = run.counters.get("grad_bound_s")
    if run.trace is None or not bound:
        return None
    spent = run.trace.grad_work_s()
    if spent <= 0:
        return None
    return 100.0 * bound / spent
