"""Quality-breadth matrix (the port's counterpart of tools/quality_matrix.py):
the eval AUC of every model variant on a large synthetic CTR set at a
realistic positive rate, trained on the card.

It generates a CTR dataset with a planted signal (default 1,000,000 train
and 100,000 eval rows, 8% positives, seed 7; ``testing.generate_ctr_tsv``),
trains each variant for one epoch on the same data at batch 512 on the
small conf (``testing.write_small_conf``: hidden units [64, 32]) and reports
eval AUC (accuracy for the 3-class head) and logloss.

Variants: wide-only, deep-only, wide_deep x connectivity {simple,
first_dense, last_dense, dense, resnet, the DAG [0-1, 0-2, 1-2]},
multi-tower, FM k = 8, and the 3-class head.

    python -m wide_deep_tpu_torch.tools.quality_matrix [--rows 1000000] \
        [--only wide,wd_fm8] [--device cpu] [--out quality_matrix_torch.json]

The generated files are reused while ``<work_dir>/dataset.json`` (written
only after all four are complete) matches the generation parameters.
Writes ``<work_dir>/quality_matrix.json`` (or ``--out``) with the device's
name (the card's name and power limit as nvidia-smi gives them) and prints
the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.tools.bench import device_name


def generate(conf_dir: str, path: str, n: int, seed: int, pos_rate: float,
             n_classes: int = 2) -> float:
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import generate_ctr_tsv
    t0 = time.time()
    achieved = generate_ctr_tsv(Config(conf_dir), path, n, seed, pos_rate,
                                n_classes)
    print(f"  wrote {n} rows -> {path} ({time.time() - t0:.0f}s, "
          f"pos/mid rate {achieved:.3f})", flush=True)
    return achieved


def conf_for(base_conf: str, dst: str, *, connected_mode=None,
             hidden_units=None, fm_factors=None) -> str:
    """``base_conf`` copied to ``dst`` with model.yaml's connectivity,
    hidden units or FM factors replaced."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(base_conf, dst)
    path = os.path.join(dst, "model.yaml")
    with open(path) as f:
        text = f.read()
    if connected_mode is not None:
        text = text.replace("dnn_connected_mode: simple",
                            f"dnn_connected_mode: {connected_mode}")
    if hidden_units is not None:
        text = re.sub(r"dnn_hidden_units: .*",
                      f"dnn_hidden_units: {hidden_units}", text, count=1)
    if fm_factors is not None:
        text = text.replace("linear_fm_factors: 0",
                            f"linear_fm_factors: {fm_factors}")
    with open(path, "w") as f:
        f.write(text)
    return dst


def variants(base: str, work_dir: str) -> List[tuple]:
    """(name, conf dir, model type, n_classes) of every variant."""
    cd = os.path.join(work_dir, "conf")
    return [
        ("wide", base, "wide", 2),
        ("deep_simple", base, "deep", 2),
        ("wide_deep_simple", base, "wide_deep", 2),
        ("wd_first_dense",
         conf_for(base, cd + "_fd", connected_mode="first_dense"),
         "wide_deep", 2),
        ("wd_last_dense",
         conf_for(base, cd + "_ld", connected_mode="last_dense"),
         "wide_deep", 2),
        ("wd_dense", conf_for(base, cd + "_d", connected_mode="dense"),
         "wide_deep", 2),
        ("wd_resnet", conf_for(base, cd + "_r", connected_mode="resnet"),
         "wide_deep", 2),
        ("wd_dag_0-1_0-2_1-2",
         conf_for(base, cd + "_dag", connected_mode="[0-1, 0-2, 1-2]"),
         "wide_deep", 2),
        ("wd_multitower",
         conf_for(base, cd + "_mt", hidden_units="[[64, 32], [32, 16]]"),
         "wide_deep", 2),
        ("wd_fm8", conf_for(base, cd + "_fm", fm_factors=8),
         "wide_deep", 2),
        ("wd_multiclass3", base, "wide_deep", 3),
    ]


def run_variant(name, conf_dir, model_type, train_path, eval_path, out_dir,
                batch_size, n_classes=2, device=None,
                on_trainer: Optional[Callable] = None) -> Dict:
    import gc

    import torch

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    t0 = time.time()
    tr = Trainer(Config(conf_dir), model_type=model_type,
                 model_dir=os.path.join(out_dir, name), n_classes=n_classes,
                 overrides=dict(train_data=train_path, eval_data=eval_path,
                                test_data=eval_path, keep_train=False,
                                batch_size=batch_size,
                                num_examples=2_000_000),
                 device=device)
    tr.ensure_initialized(restore=False)
    if on_trainer is not None:
        on_trainer(name, tr)
    tr.train_file(train_path)
    res = tr.evaluate(eval_path)
    metric = res.get("auc", res.get("accuracy"))
    row = {"variant": name, "model_type": model_type,
           "n_classes": n_classes,
           "auc": round(float(res["auc"]), 4) if "auc" in res else None,
           "accuracy": round(float(res.get("accuracy", 0)), 4),
           "logloss": round(float(res["loss"]), 4),
           "steps": tr.global_step,
           "train_s": round(time.time() - t0, 1)}
    print(f"  {name:24s} metric={metric:.4f} loss={res['loss']:.4f} "
          f"({row['train_s']}s)", flush=True)
    del tr
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv: Optional[Sequence[str]] = None,
         on_trainer: Optional[Callable] = None) -> Dict:
    """-> the written result; ``on_trainer(name, tr)``, where given, sees
    each variant's initialised Trainer before it trains."""
    p = argparse.ArgumentParser(description="quality-breadth matrix")
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--eval_rows", type=int, default=100_000)
    p.add_argument("--pos_rate", type=float, default=0.08)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--work_dir", default=os.path.join(
        tempfile.gettempdir(), "wdt_quality_matrix_torch"))
    p.add_argument("--only", default="",
                   help="comma list of variant names to run (default all)")
    p.add_argument("--out", default=None,
                   help="result file (default <work_dir>/quality_matrix.json)")
    p.add_argument("--device", default=None,
                   help="'cpu' trains on the host; default: the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.work_dir, exist_ok=True)
    from wide_deep_tpu_torch.testing import write_small_conf
    base = write_small_conf(os.path.join(args.work_dir, "conf_base"),
                            hidden_units="[64, 32]",
                            batch_size=args.batch_size)
    train2 = os.path.join(args.work_dir, "train2.tsv")
    eval2 = os.path.join(args.work_dir, "eval2.tsv")
    train3 = os.path.join(args.work_dir, "train3.tsv")
    eval3 = os.path.join(args.work_dir, "eval3.tsv")
    # the marker is written only after all four files are complete, keyed
    # by the generation parameters: an interrupted or re-parameterized run
    # regenerates instead of training on truncated or stale files
    marker = os.path.join(args.work_dir, "dataset.json")
    want = {"rows": args.rows, "eval_rows": args.eval_rows,
            "pos_rate": args.pos_rate, "seed": args.seed}
    have = None
    if os.path.exists(marker):
        with open(marker) as f:
            have = json.load(f)
    print("generating data...", flush=True)
    if have != want:
        generate(base, train2, args.rows, args.seed, args.pos_rate)
        generate(base, eval2, args.eval_rows, args.seed + 1, args.pos_rate)
        generate(base, train3, args.rows // 4, args.seed + 2, args.pos_rate,
                 n_classes=3)
        generate(base, eval3, args.eval_rows, args.seed + 3, args.pos_rate,
                 n_classes=3)
        with open(marker, "w") as f:
            json.dump(want, f)

    todo = variants(base, args.work_dir)
    if args.only:
        keep = set(args.only.split(","))
        todo = [v for v in todo if v[0] in keep]
    rows = []
    for name, conf_dir, model_type, n_classes in todo:
        tr_path, ev_path = ((train2, eval2) if n_classes == 2
                            else (train3, eval3))
        rows.append(run_variant(name, conf_dir, model_type, tr_path, ev_path,
                                os.path.join(args.work_dir, "m"),
                                args.batch_size, n_classes, device,
                                on_trainer))
    out = args.out or os.path.join(args.work_dir, "quality_matrix.json")
    result = {"device": device_name(device), "rows": args.rows,
              "eval_rows": args.eval_rows, "pos_rate": args.pos_rate,
              "batch_size": args.batch_size, "seed": args.seed,
              "results": rows}
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"results -> {out}")
    print(json.dumps(rows, indent=1))
    return result


if __name__ == "__main__":
    main()
