"""PySpark driver for offline preprocessing at HDFS/YARN scale (the port's
copy of the JAX package's ``offline/spark_job.py``).

Reference: the reference's python/spark/data_process.py:75-147 — per date:
1/7/30-day windows, per-category-column CTR-rate broadcast join, stratified
negative down-sampling, 2-partition save; the driver loop validates input
paths and clears the output path.  Shares its math with ctr_features.py so
the local driver and tests exercise identical logic without a cluster.
The executors import ``wide_deep_tpu_torch.offline.ctr_features`` from a zip
of this package that the driver ships with the job (``package_zip``: the
``--py-files`` of a spark-submit).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import zipfile
from typing import List, Optional

from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.offline import ctr_features as cf


def exist_hdfs_path(path: str) -> bool:
    # list argv, no shell: a configured path containing spaces or shell
    # metacharacters must be tested literally, not re-parsed by a shell
    return subprocess.call(["hadoop", "fs", "-test", "-e", path]) == 0


def _clear_hdfs_path(path: str) -> None:
    subprocess.call(["hadoop", "fs", "-rm", "-r", path])


def _clk(label: str) -> int:
    """Tolerant label parse — ctr_features.ctr_rate_map semantics: a
    malformed/non-numeric label counts as a non-click instead of killing
    the whole cluster job in a reduceByKey retry loop."""
    try:
        return int(label)
    except ValueError:
        return 0


def package_zip(out_dir: Optional[str] = None) -> str:
    """Zip ``wide_deep_tpu_torch`` (its .py files) for the executors ->
    the zip's path, under ``out_dir`` (a new temporary dir by default)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg)
    path = os.path.join(out_dir or tempfile.mkdtemp(prefix="wdt_spark_"),
                        "wide_deep_tpu_torch.zip")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, dirnames, files in os.walk(pkg):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    full = os.path.join(dirpath, f)
                    z.write(full, os.path.relpath(full, root))
    return path


def hdfs_data_preprocess(inpath: List[str], outpath: str,
                         feature_index_list: List[int],
                         keep_prob: float, seed: int = 0,
                         num_output_partitions: int = 2,
                         master: str = "yarn") -> None:
    """Process one date's window on a Spark cluster."""
    from pyspark import SparkConf, SparkContext

    # validate/clear HERE (idempotent for main): tools/data_process.py
    # calls this function directly, and a rerun of an existing date would
    # otherwise compute every rate map before dying in
    # saveAsTextFile(FileAlreadyExists)
    # the TARGET day must exist; older window history may be partial
    # (local_job tolerates missing days the same way)
    if not inpath or not exist_hdfs_path(inpath[0]):
        raise IOError(f"Hdfs path: {inpath[:1]} not exists")
    inpath = [p for p in inpath if exist_hdfs_path(p)]
    if exist_hdfs_path(outpath):
        _clear_hdfs_path(outpath)

    sc = SparkContext(conf=SparkConf().setMaster(master))
    try:
        sc.addPyFile(package_zip())
        window_paths = {1: inpath[:1], 7: inpath[:7], 30: inpath}
        day = sc.textFile(",".join(window_paths[1])).map(
            lambda x: x.strip().split("\t"))

        rate_maps = []
        for window in cf.WINDOWS:
            rdd = sc.textFile(",".join(window_paths[window])).map(
                lambda x: x.strip().split("\t"))
            for idx in feature_index_list:
                pair = (rdd.map(lambda x, i=idx: (x[i - 1], _clk(x[0])))
                        .mapValues(lambda v: (v, 1))
                        .reduceByKey(lambda a, b: (a[0] + b[0], a[1] + b[1]))
                        .mapValues(lambda v: float(v[0]) / v[1]))
                rate_maps.append((idx, sc.broadcast(pair.collectAsMap())))

        def transform(row, maps=rate_maps):
            resolved = [(idx, b.value) for idx, b in maps]
            return cf.append_rate_columns(row, resolved)

        # sample on the BASE row, before the rate columns are appended —
        # ctr_features.process_day (the local engine) hashes the base row
        # too, so both engines keep the same rows AND the sampling
        # decision stays independent of the (history-dependent) rate
        # values: a rerun with one more day of history keeps identical
        # rows
        data = day.filter(lambda row: cf.keep_row(row, keep_prob, seed))
        if feature_index_list:
            data = data.map(transform)
        (data.map(lambda row: "\t".join(row))
             .repartition(num_output_partitions)
             .saveAsTextFile(outpath))
    finally:
        sc.stop()


def main(config: Optional[Config] = None) -> None:
    config = config or Config()
    conf = config.data_process
    feature_index_list = conf["category_feature_index_list"]
    keep_prob = conf["downsampling_keep_ratio"]
    start, end = str(conf["start_date"]), str(conf["end_date"])
    dates = cf.list_dates(start, end)

    for date in dates:
        print(f"Start processing date: {date}")
        inpath = [os.path.join(conf["input_hdfs_dir"], d)
                  for d in cf.gen_dates(date, 30)]
        outpath = os.path.join(conf["output_hdfs_dir"], date)
        # validation + clear live in hdfs_data_preprocess (shared with the
        # tools/data_process.py direct caller)
        hdfs_data_preprocess(inpath, outpath, feature_index_list, keep_prob)


if __name__ == "__main__":
    main()
