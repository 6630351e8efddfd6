"""Rows of a Criteo-like click log for the DLRM-DCNv2 cells, made from the
seed.

A row is the click label, the dense counts (log-normal, a share
``missing`` of them ``-``) and, for each categorical feature, exactly its
hotness of values (``max_len``, kept whole by the configuration's pack
budget), comma-separated.  A feature's values are drawn zipf(``zipf_a``)
and taken modulo the rows the feature holds on this chip, then written as
``<feature>_<draw>``: the program's hash spreads them over its rows, as
production ids are spread.  The label is drawn from a planted signal (the
first two features' hottest values and the first count) re-centred to the
positive rate ``pos_rate``.

A file is made of blocks of ``BLOCK_ROWS`` rows, block k drawn from
``default_rng([seed, k])``, by a few forked worker processes (numpy only):
the rows depend on the seed alone.
"""

from __future__ import annotations

import multiprocessing
from typing import Any, Dict, List, Tuple

import numpy as np

BLOCK_ROWS = 8_192
WORKERS = 6


def block_text(dense: List[str], sparse: List[Tuple[str, int, int, bool]],
               n: int, rng: np.random.Generator, params: Dict[str, Any]
               ) -> bytes:
    zipf_a = float(params["zipf_a"])
    counts = np.floor(rng.lognormal(float(params["count_mu"]),
                                    float(params["count_sigma"]),
                                    (n, len(dense)))).astype(np.int64)
    missing = rng.random((n, len(dense))) < float(params["missing"])
    cols: List[np.ndarray] = []
    for j in range(len(dense)):
        c = np.char.mod("%d", counts[:, j])
        c[missing[:, j]] = "-"
        cols.append(c)
    first = []
    for name, rows, hot, _ in sparse:
        draws = rng.zipf(zipf_a, (n, hot)) % rows
        first.append(draws[:, 0])
        vals = np.char.add(name + "_", np.char.mod("%d", draws))
        cols.append(np.array([",".join(r) for r in vals.tolist()]))
    score = (1.5 * (first[0] < 4) + 1.0 * (first[1] == 1)
             + 0.5 * np.log1p(np.where(missing[:, 0], 0, counts[:, 0])))
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if float(np.mean(1 / (1 + np.exp(-(score + mid))))) > float(
                params["pos_rate"]):
            hi = mid
        else:
            lo = mid
    p = 1 / (1 + np.exp(-(score + (lo + hi) / 2)))
    labels = np.char.mod("%d", (rng.random(n) < p).astype(int))
    return ("\n".join("\t".join(v) for v in zip(labels, *cols))
            + "\n").encode()


def _block(args) -> bytes:
    dense, sparse, seed, k, n, params = args
    rng = np.random.default_rng([int(seed), int(k)])
    return block_text(dense, sparse, n, rng, params)


def write_rows(spec, path: str, n_rows: int, seed: int,
               params: Dict[str, Any], workers: int = WORKERS) -> int:
    """Write ``n_rows`` rows to ``path`` in the column order of ``spec``'s
    schema (reference/dcn.Spec: label, dense, categorical); -> bytes
    written.  Call before the process touches the card: the workers are
    forked."""
    order = sorted(spec.column, key=spec.column.get)
    if order[1:] != spec.dense + [s[0] for s in spec.sparse]:
        raise ValueError("the rows are written label, dense, categorical")
    jobs = [(spec.dense, spec.sparse, seed, k,
             min(BLOCK_ROWS, n_rows - lo), params)
            for k, lo in enumerate(range(0, n_rows, BLOCK_ROWS))]
    total = 0
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(min(workers, len(jobs))) as pool, open(path, "wb") as f:
        for blob in pool.imap(_block, jobs):
            f.write(blob)
            total += len(blob)
        pool.close()
        pool.join()
    return total
