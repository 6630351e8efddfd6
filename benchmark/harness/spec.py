"""What BENCHMARK.json names, found by name under the benchmark's folder:
a cell (``workloads``), its configuration (the entry's ``file``,
``configs/<name>.json``, whose ``conf`` names the frozen ``conf/*.yaml``
of its source under ``sources/``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
SPEC_FILE = os.path.join(REPO_ROOT, "BENCHMARK.json")


def load(path: str = SPEC_FILE) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, spec: Dict[str, Any] = None):
        spec = spec or load()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _read_json(os.path.join(REPO_ROOT,
                                              self.config_entry["file"]))
        self.conf_dir = os.path.join(BENCH_DIR, self.config["conf"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = _read_json(os.path.join(
            BENCH_DIR, "traffic", f"{self.traffic_name}.json"))
        self.limits = _read_json(os.path.join(BENCH_DIR, "limits",
                                              f"{name}.json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if self._reports(spec, m)]
        self.run_seconds = int(spec["run_seconds"])

    @classmethod
    def from_parts(cls, name: str, conf_dir: str, config: Dict[str, Any],
                   traffic: Dict[str, Any], limits: Dict[str, Any],
                   chips: int = 1, per_layer=(), end_to_end=()) -> "Cell":
        """A cell that BENCHMARK.json does not hold (tests: a small
        configuration whose conf/*.yaml lie in ``conf_dir``)."""
        cell = cls.__new__(cls)
        cell.name = name
        cell.workload = {"name": name, "chips": chips}
        cell.config_entry = {}
        cell.conf_dir = conf_dir
        cell.config = config
        cell.traffic_name = ""
        cell.traffic = traffic
        cell.limits = limits
        cell.end_to_end = list(end_to_end)
        cell.per_layer = list(per_layer)
        cell.run_seconds = 1
        return cell

    def _reports(self, spec, metric) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moved = [m for m in spec["end_to_end"] if m["name"] == metric["moves"]]
        return bool(moved) and self.name in moved[0].get("workloads",
                                                         [self.name])


def metric_reader(name: str) -> Callable[[Any], Any]:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

