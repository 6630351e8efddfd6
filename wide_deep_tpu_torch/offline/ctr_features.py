"""Pure preprocessing logic: CTR-rate feature generation + stratified
down-sampling (the port's copy of the JAX package's
``offline/ctr_features.py``: the same rows, columns and bytes).

Reference semantics (the reference's python/spark/data_process.py:75-117):

* For each configured category column (1-based schema index) and each lookback
  window (1 / 7 / 30 days), compute the per-value mean click rate over the
  window and append it to each current-day row as a new continuous column —
  e.g. a per-city CTR over the last week becomes a dense feature.
* Down-sample: keep every positive, keep negatives with probability
  ``keep_prob`` (the data is extremely imbalanced; conf
  data_process.yaml: 0.01).

Divergences (documented): missing keys fall back to rate 0.0 instead of
raising, and sampling is deterministic per row (seeded xxh64 of the row)
rather than Spark's RNG stream, so reruns produce identical output.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

from wide_deep_tpu_torch.features.hashing import fingerprint64

WINDOWS = (1, 7, 30)  # lookback windows in days


def gen_dates(start: str, days: int = 1, fmt: str = "%Y%m%d") -> List[str]:
    """The ``days`` dates ending at (and including) ``start``, newest first
    (data_process.py:46-50)."""
    d0 = datetime.strptime(start, fmt)
    day = timedelta(days=1)
    return [(d0 - day * i).strftime(fmt) for i in range(days)]


def list_dates(start: str, end: str, fmt: str = "%Y%m%d") -> List[str]:
    """Inclusive date range (data_process.py:53-58)."""
    d0 = datetime.strptime(start, fmt)
    d1 = datetime.strptime(end, fmt)
    return [(d0 + timedelta(i)).strftime(fmt)
            for i in range((d1 - d0).days + 1)]


def ctr_rate_map(rows: Iterable[Sequence[str]],
                 col_index: int) -> Dict[str, float]:
    """Per-value mean click rate for 1-based schema column ``col_index``
    (label is column 1).  The reduceByKey (sum, count) -> mean logic."""
    sums: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for row in rows:
        key = row[col_index - 1]
        try:
            clk = int(row[0])
        except ValueError:
            clk = 0
        sums[key] = sums.get(key, 0) + clk
        counts[key] = counts.get(key, 0) + 1
    return {k: sums[k] / counts[k] for k in counts}


def append_rate_columns(row: List[str],
                        rate_maps: Sequence[Tuple[int, Dict[str, float]]]
                        ) -> List[str]:
    """Append one new continuous column per (window, feature) rate map, in
    order.  Missing keys -> 0.0 (deliberate fix of the reference KeyError)."""
    out = list(row)
    for col_index, rates in rate_maps:
        out.append(repr(rates.get(row[col_index - 1], 0.0)))
    return out


def keep_row(row: Sequence[str], keep_prob: float, seed: int = 0) -> bool:
    """Stratified down-sampling decision: positives always kept, negatives
    kept with probability keep_prob, deterministically per row."""
    if row[0] == "1":
        return True
    if keep_prob >= 1.0:
        return True
    h = fingerprint64(("\t".join(row)).encode("utf-8"), seed)
    return (h / 2.0 ** 64) < keep_prob


def process_day(day_rows: List[List[str]],
                window_rows: Dict[int, List[List[str]]],
                feature_index_list: Sequence[int],
                keep_prob: float, seed: int = 0) -> Iterator[List[str]]:
    """Full per-date pipeline over in-memory rows.

    ``window_rows``: {window_days: rows covering that window (newest day
    first, includes day_rows)}.
    """
    rate_maps: List[Tuple[int, Dict[str, float]]] = []
    for window in WINDOWS:
        rows_w = window_rows.get(window, day_rows)
        for idx in feature_index_list:
            rate_maps.append((idx, ctr_rate_map(rows_w, idx)))
    for row in day_rows:
        if not keep_row(row, keep_prob, seed):
            continue
        yield append_rate_columns(row, rate_maps) if rate_maps else list(row)
