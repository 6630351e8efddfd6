"""Offline preprocessing CLI: windowed CTR-rate features + down-sampling (the
port's copy of tools/data_process.py; the same flags, the same bytes).

Local mode runs anywhere (no Spark); --engine spark submits the PySpark
driver for HDFS-scale data (reference python/spark/data_process.py).

    python -m wide_deep_tpu_torch.tools.data_process --engine local \
        --input_dir IN --output_dir OUT --start_date 20180112 \
        --end_date 20180112 --keep_ratio 0.05 --feature_index 9

Defaults come from data_process.yaml of the conf dir WIDE_DEEP_CONF_DIR
names (conf/ otherwise).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    from wide_deep_tpu_torch.config import Config
    config = Config(os.environ.get("WIDE_DEEP_CONF_DIR"))
    conf = config.data_process
    p = argparse.ArgumentParser(description="offline data preprocessing")
    p.add_argument("--engine", choices=["local", "spark"], default="local")
    p.add_argument("--input_dir", default=conf["input_hdfs_dir"])
    p.add_argument("--output_dir", default=conf["output_hdfs_dir"])
    p.add_argument("--start_date", default=str(conf["start_date"]))
    p.add_argument("--end_date", default=str(conf["end_date"]))
    p.add_argument("--keep_ratio", type=float,
                   default=conf["downsampling_keep_ratio"])
    p.add_argument("--feature_index", type=int, nargs="*",
                   default=conf["category_feature_index_list"])
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.offline import ctr_features as cf
    dates = cf.list_dates(args.start_date, args.end_date)
    if args.engine == "spark":
        from wide_deep_tpu_torch.offline import spark_job
        for date in dates:
            inpath = [os.path.join(args.input_dir, d)
                      for d in cf.gen_dates(date, 30)]
            spark_job.hdfs_data_preprocess(
                inpath, os.path.join(args.output_dir, date),
                args.feature_index, args.keep_ratio)
    else:
        from wide_deep_tpu_torch.offline.local_job import (
            local_data_preprocess)
        for date in dates:
            n = local_data_preprocess(args.input_dir, args.output_dir, date,
                                      args.feature_index, args.keep_ratio)
            print(f"{date}: wrote {n} rows")


if __name__ == "__main__":
    main()
