"""Rows of the click log, made from the seed.

``block_text`` is a frozen copy of wide_deep_tpu_torch/testing.py's
``generate_ctr_tsv`` at commit 5396835d8e2c28384b317c5c7862110fa5df19db
(schema-conformant rows, a planted hour/site/age/gender signal re-centred
to the positive rate, zipf-skewed hash ids, 3% missing continuous values),
with its parameters read from the traffic mix and its output returned as
bytes.  A file is made of blocks of ``BLOCK_ROWS`` rows, block k drawn
from ``default_rng([seed, k])``, so the rows depend on the seed alone and
not on how many processes write them; the blocks are made by a few worker
processes at once.
"""

from __future__ import annotations

import multiprocessing
from typing import Any, Dict, List, Optional

import numpy as np

BLOCK_ROWS = 25_600
WORKERS = 6


def block_text(schema: List[str], feature_conf: Dict[str, Any], n: int,
               rng: np.random.Generator, pos_rate: float, zipf_a: float,
               hash_spread: Optional[int], missing: float) -> bytes:
    cols = {}
    for name in schema[1:]:
        conf = feature_conf.get(name)
        if conf is None:
            pool = np.array([f"x{i}" for i in range(1000)])
            cols[name] = pool[rng.integers(0, len(pool), n)]
        elif conf["type"] == "continuous":
            a, b = conf["parameter"].get("normalization", [0, 1])
            s = np.char.mod("%.4f", rng.uniform(a, b, n))
            s[rng.random(n) < missing] = "-"
            cols[name] = s
        elif conf["transform"] == "vocab":
            pool = np.array([str(v) for v in conf["parameter"]])
            cols[name] = pool[rng.integers(0, len(pool), n)]
        elif conf["transform"] == "identity":
            cols[name] = np.char.mod("%d", rng.integers(
                0, conf["parameter"], n))
        else:  # hash_bucket: skewed ids like real logs
            # hash_spread None: distinct values in proportion to the
            # feature's hash space, so the kernel plans see production-like
            # id streams
            spread = hash_spread or max(
                1000, min(int(conf["parameter"]), 1_000_000))
            ids = rng.zipf(zipf_a, n) % spread
            cols[name] = np.char.add(name[:2], np.char.mod("%d", ids))

    score = np.zeros(n)
    hour = cols["hour"].astype(int)
    score += np.where((hour >= 18) & (hour <= 23), 1.8, 0.0)
    score += np.where(np.isin(cols["site"], ["1", "2"]), 1.5, 0.0)
    age = np.where(cols["age"] == "-", "999", cols["age"]).astype(float)
    score += np.where(age < 30, 1.2, 0.0)
    score += np.where(cols["ugender"] == "male", 1.0, 0.0)
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if float(np.mean(1 / (1 + np.exp(-(score + mid))))) > pos_rate:
            hi = mid
        else:
            lo = mid
    p = 1 / (1 + np.exp(-(score + (lo + hi) / 2)))
    label = (rng.random(n) < p).astype(int)
    labels = np.char.mod("%d", label)
    mat = [labels] + [cols[c] for c in schema[1:]]
    return ("\n".join("\t".join(vals) for vals in zip(*mat)) + "\n").encode()


def _block(args) -> bytes:
    schema, feature_conf, seed, k, n, params = args
    rng = np.random.default_rng([int(seed), int(k)])
    return block_text(schema, feature_conf, n, rng, **params)


def row_params(traffic: Dict[str, Any]) -> Dict[str, Any]:
    rows = traffic["rows"]
    return {"pos_rate": float(rows["pos_rate"]),
            "zipf_a": float(rows["zipf_a"]),
            "hash_spread": rows.get("hash_spread"),
            "missing": float(rows["missing"])}


def write_rows(config, path: str, n_rows: int, seed: int,
               traffic: Dict[str, Any], workers: int = WORKERS) -> int:
    """Write ``n_rows`` rows (whole blocks) to ``path``; -> bytes written.
    ``config`` is a reference Config (its schema and feature conf).  Call
    before the process touches the card: the workers are forked."""
    schema = config.schema_columns()
    feature_conf = config.read_feature_conf()
    params = row_params(traffic)
    jobs = [(schema, feature_conf, seed, k, min(BLOCK_ROWS, n_rows - lo),
             params) for k, lo in enumerate(range(0, n_rows, BLOCK_ROWS))]
    total = 0
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(min(workers, len(jobs))) as pool, open(path, "wb") as f:
        for blob in pool.imap(_block, jobs):
            f.write(blob)
            total += len(blob)
        pool.close()
        pool.join()
    return total


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()
