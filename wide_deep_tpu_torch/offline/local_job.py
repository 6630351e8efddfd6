"""Local-filesystem offline preprocessing (no Spark needed).

The reference validated its Spark logic with a local-mode variant
(the reference's python/spark/data_process_local_test.py); this module is
that idea promoted to a real tool: identical math (ctr_features.py), plain
files, date-partitioned directories ``<root>/<YYYYMMDD>/part-*``.  The
port's copy of the JAX package's ``offline/local_job.py``; it reads and
writes UTF-8 whatever the locale, as the port's loaders do.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from wide_deep_tpu_torch.offline import ctr_features as cf


def _read_rows(paths: Sequence[str]) -> List[List[str]]:
    rows = []
    for path in paths:
        if os.path.isdir(path):
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if not f.startswith("."))
        else:
            files = [path]
        for fp in files:
            with open(fp, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        rows.append(line.split("\t"))
    return rows


def local_data_preprocess(input_root: str, output_root: str, date: str,
                          feature_index_list: Sequence[int],
                          keep_prob: float, seed: int = 0,
                          num_output_partitions: int = 2) -> int:
    """Process one date from ``<input_root>/<date>`` (falling back to a flat
    file/dir if date subdirs don't exist); returns rows written."""
    day_paths = [os.path.join(input_root, d) for d in cf.gen_dates(date, 30)]
    existing = [p for p in day_paths if os.path.exists(p)]
    if not existing:
        if os.path.exists(input_root):
            existing = [input_root]
        else:
            raise IOError(f"no input at {input_root}")
    day_rows = _read_rows(existing[:1])
    window_rows = {
        1: day_rows,
        7: _read_rows(existing[:7]),
        30: _read_rows(existing),
    }
    out_rows = list(cf.process_day(day_rows, window_rows,
                                   feature_index_list, keep_prob, seed))
    out_dir = os.path.join(output_root, date)
    os.makedirs(out_dir, exist_ok=True)
    n_parts = max(num_output_partitions, 1)
    writers = [open(os.path.join(out_dir, f"part-{i:05d}"), "w",
                    encoding="utf-8")
               for i in range(n_parts)]
    try:
        for i, row in enumerate(out_rows):
            writers[i % n_parts].write("\t".join(row) + "\n")
    finally:
        for w in writers:
            w.close()
    return len(out_rows)


def dataframe_preprocess(rows: List[List[str]],
                         feature_index_list: Sequence[int],
                         keep_prob: float, seed: int = 0,
                         schema: Optional[Sequence[str]] = None):
    """DataFrame-flavor variant: the reference validated its Spark logic
    twice — once with the RDD sum/count math (``process_day`` here) and
    once join-shaped (per-feature rate TABLE, left-outer-joined back onto
    the frame as a named ``<feature>_rate_1`` column, then stratified
    sampleBy; reference python/spark/data_process_local_test.py:26-49).

    Semantics preserved: 1-day window only (the DF flavor never computed
    the 7/30-day windows), named output columns, left-outer join (a key
    absent from the rate table joins as None -> serialized ''); stratified
    sampling keeps every positive and ``keep_prob`` of negatives.

    Returns (header, out_rows): header lists the appended column names.
    """
    header = []
    joined = [list(r) for r in rows]
    for idx in feature_index_list:
        name = (schema[idx - 1] if schema and idx - 1 < len(schema)
                else f"col{idx}")
        header.append(f"{name}_rate_1")
        table = cf.ctr_rate_map(rows, idx)  # the groupByKey.mean table
        for row in joined:                  # left_outer join on the key
            rate = table.get(row[idx - 1])
            row.append("" if rate is None else repr(rate))
    out = [r for r in joined if cf.keep_row(r, keep_prob, seed)]
    return header, out
