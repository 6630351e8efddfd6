"""Device milliseconds a traced step in GEMM kernels (the frozen bucket
rules of harness/trace.py)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.bucket_ms_per_step().get("matmul", 0.0)
