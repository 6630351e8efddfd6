"""A run's conf directory: the frozen ``conf/*.yaml`` of the configuration's
source with the keys its configuration file sets (``set``: {file: {section
or key: value or {key: value}}}) and the run's own settings (the seed, the
model dir) written over them."""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import yaml


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def write_conf(cell, out_dir: str, seed: int, model_dir: str) -> str:
    """Write the cell's configuration, seeded, into ``out_dir/conf``."""
    src = cell.conf_dir
    dst = os.path.join(out_dir, "conf")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    sets: Dict[str, Dict[str, Any]] = {
        k: dict(v) for k, v in cell.config.get("set", {}).items()}
    run = {"train.yaml": {"train": {"model_dir": model_dir},
                          "runconfig": {"tf_random_seed": int(seed)}}}
    for name, changes in run.items():
        _merge(sets.setdefault(name, {}), changes)
    for name, changes in sets.items():
        path = os.path.join(dst, name)
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        _merge(doc, changes)
        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
    return dst
