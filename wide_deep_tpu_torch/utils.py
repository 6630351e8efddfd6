"""Small cross-cutting utilities (the port's copy of the JAX package's
``utils.py``, after the reference's python/lib/utils/util.py): the
schema's dtype map for clients, and ``profile_trace``, a ``torch.profiler``
scope that writes a Chrome trace and the program's spans (tracing.py)
into a directory."""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict, Optional

log = logging.getLogger("wide_deep_tpu_torch")


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
    one); its Chrome trace goes to ``<logdir>/trace_<pid>.json`` and the
    program's spans and counters of the scope (``tracing.snapshot``, the
    last ``tracing.MAX_RECORDS`` spans) to ``<logdir>/spans_<pid>.json``.
    No-op when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wide_deep_tpu_torch import tracing
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracing.reset()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    spans = os.path.join(logdir, f"spans_{os.getpid()}.json")
    with open(spans, "w") as f:
        json.dump(tracing.snapshot(), f)
    log.info("profiler trace written to %s, spans to %s", path, spans)
