"""Small cross-cutting utilities (the port's copy of the JAX package's
``utils.py``, after the reference's python/lib/utils/util.py).

``timer`` / ``elapse_time`` instrumentation, the schema's dtype map for
clients, and ``profile_trace``, a ``torch.profiler`` scope that writes a
Chrome trace into a directory."""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("wide_deep_tpu_torch")


def timer(info: str = ""):
    """Decorator logging the wrapped call's wall time (util.py:18-29)."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            start = time.time()
            result = fn(*args, **kwargs)
            log.info("%s elapsed %.2f s", info or fn.__name__,
                     time.time() - start)
            return result
        return wrapper
    return decorate


def elapse_time(start: float) -> float:
    """Seconds elapsed since ``start`` (util.py:32-33)."""
    return round(time.time() - start, 3)


def column_to_dtype(config) -> Dict[str, str]:
    """Schema column -> dtype name for client-side serialization
    (util.py:61-80): label + identity + continuous are numeric, everything
    else string."""
    feature_conf = config.read_feature_conf()
    out = {config.label_column: "int64"}
    for name in config.schema_columns()[1:]:
        conf = feature_conf.get(name)
        if conf is None:
            out[name] = "string"
        elif conf["type"] == "continuous":
            out[name] = "float32"
        elif conf["transform"] == "identity":
            out[name] = "int64"
        else:
            out[name] = "string"
    return out


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` over the scope (host, and the card when there is
    one); its Chrome trace goes to ``<logdir>/trace_<pid>.json``.  No-op
    when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
