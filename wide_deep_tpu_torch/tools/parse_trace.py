"""Per-name device time of a torch.profiler Chrome trace (the port's
counterpart of tools/parse_xplane.py).

``torch.profiler.profile(...).export_chrome_trace(path)`` writes the
trace the bench tool leaves under ``BENCH_PROFILE``
(tools/bench.py: ``<dir>/trace.json``).  Its device events are the
complete events (``"ph": "X"``) of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``, with durations in microseconds; host
events (``cpu_op``, ``cuda_runtime``, ...) and the device-side copies of
host annotations (``gpu_user_annotation``, which overlap the kernels they
enclose) are left out.

    python -m wide_deep_tpu_torch.tools.parse_trace DIR_OR_TRACE [top_n]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_files(root: str) -> List[str]:
    """The Chrome traces at ``root``: the file itself, or every
    ``*.json`` / ``*.json.gz`` under the directory."""
    if os.path.isfile(root):
        return [root]
    return sorted(glob.glob(os.path.join(root, "**", "*.json"),
                            recursive=True)
                  + glob.glob(os.path.join(root, "**", "*.json.gz"),
                              recursive=True))


def _events(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def device_events(root: str) -> Dict[str, Tuple[float, int]]:
    """-> {event name: (total microseconds, number of events)} over the
    device events of every trace at ``root``."""
    out: Dict[str, Tuple[float, int]] = {}
    for path in trace_files(root):
        for e in _events(path):
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
                continue
            name = e.get("name", "")
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + float(e.get("dur", 0.0)), n + 1)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__.strip().splitlines()[-1].strip())
        return 2
    root = argv[0]
    top_n = int(argv[1]) if len(argv) > 1 else 30
    ev = device_events(root)
    if not ev:
        print(f"no device events in a trace under {root}")
        return 1
    total = sum(us for us, _ in ev.values())
    print(f"total device event time: {total / 1e3:.3f} ms over "
          f"{sum(n for _, n in ev.values())} events")
    for name, (us, n) in sorted(ev.items(), key=lambda kv: -kv[1][0])[
            :top_n]:
        print(f"{us / 1e3:9.3f} ms  x{n:<5d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
