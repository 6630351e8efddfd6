"""Quality on the card (the port's counterpart of tools/quality_onchip.py):
the production config (conf/ as shipped: the full 10,000,640-row wide
table, the fused 10,000,128-row d32 table, the sparse optimizer) trained
on the card to an eval metric.

  A. reference-data convergence: wide_deep, 2 epochs over
     ``<reference_data>/train``, evaluated on ``<reference_data>/eval``
     after each epoch (logloss, accuracy, prediction/mean);
     ``--reference_data`` defaults to the repo's data/, and a directory
     that does not exist falls back to it;
  B. learnable-signal AUC: each model type (wide, deep, wide_deep), 5
     epochs over the repo's data/train (its planted CTR signal) at batch
     64, AUC on data/eval/eval1, each Trainer's card memory freed before
     the next.

    python -m wide_deep_tpu_torch.tools.quality_onchip [--part A|B|AB] \
        [--device cpu] [--seed N] [--reference_data DIR]

Prints a markdown table per part on stdout (a row per epoch or model
type, its seconds in a comment) and, last, one JSON line of both parts'
rows with the device's name (the card's name and power limit as
nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from wide_deep_tpu_torch.features.native import REPO_ROOT
from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.tools.bench import device_name

DATA = os.path.join(REPO_ROOT, "data")
TRAIN = os.path.join(DATA, "train")
EVAL = os.path.join(DATA, "eval", "eval1")
MODEL_TYPES = ("wide", "deep", "wide_deep")
EPOCHS = 5                  # part B's


def release(tr) -> None:
    """Free a Trainer's card memory (the fused d32 table alone is 5 GB, so
    two live production Trainers do not fit beside each other)."""
    tr.params = tr.mstate = tr.opt_state = None
    if tr._ckpt is not None:
        tr._ckpt.close()
    gc.collect()
    if tr.device.type == "cuda":
        torch.cuda.empty_cache()


def _trainer(config, model_type: str, device, seed=None, **overrides):
    """An initialised Trainer at batch 64; ``seed`` (default: the conf's
    tf_random_seed) draws its weights and its shuffle orders."""
    from wide_deep_tpu_torch.training.loop import Trainer
    tr = Trainer(config, model_type=model_type,
                 model_dir=tempfile.mkdtemp(prefix="wdt_q_"),
                 overrides=dict(keep_train=True, batch_size=64,
                                **overrides), device=device)
    if seed is not None:
        tr.seed = seed
        tr._gen.manual_seed(seed)
    tr.ensure_initialized(restore=False)
    return tr


def part_a(device, reference_data: Optional[str] = None, epochs: int = 2,
           seed: Optional[int] = None) -> List[Dict]:
    from wide_deep_tpu_torch.config import Config
    ref = reference_data if reference_data and os.path.isdir(
        reference_data) else DATA
    print(f"# Part A: reference-data convergence ({ref}, "
          f"{device_name(device)})", flush=True)
    tr = _trainer(Config(), "wide_deep", device, seed,
                  train_data=f"{ref}/train", eval_data=f"{ref}/eval",
                  test_data=f"{ref}/eval")
    print("| epoch | eval logloss | accuracy | prediction/mean |")
    print("|---|---|---|---|")
    rows = []
    for epoch in range(epochs):
        t0 = time.time()
        for f in sorted(os.listdir(f"{ref}/train")):
            tr.train_file(os.path.join(ref, "train", f), epoch_seed=epoch)
        res = tr.evaluate(f"{ref}/eval")
        rows.append({"epoch": epoch, "average_loss": res["average_loss"],
                     "accuracy": res["accuracy"],
                     "prediction/mean": res["prediction/mean"],
                     "seconds": time.time() - t0})
        print(f"| {epoch} | {res['average_loss']:.4f} "
              f"| {res['accuracy']:.4f} | {res['prediction/mean']:.4f} |"
              f"  <!-- {time.time() - t0:.0f}s -->", flush=True)
    release(tr)
    return rows


def part_b(device, on_trainer: Optional[Callable] = None,
           seed: Optional[int] = None) -> List[Dict]:
    """-> a row per model type: auc, average_loss, prediction/mean, steps,
    seed, seconds.  ``on_trainer(tr)``, where given, sees each initialised
    Trainer before it trains (``chip_smoke.py`` counts its launches)."""
    from wide_deep_tpu_torch.config import Config
    print(f"# Part B: learnable-signal AUC (production config, {EPOCHS} "
          f"epochs, batch 64, {device_name(device)})", flush=True)
    print("| model_type | eval AUC | logloss | prediction/mean |")
    print("|---|---|---|---|")
    rows = []
    for model_type in MODEL_TYPES:
        t0 = time.time()
        tr = _trainer(Config(), model_type, device, seed, train_data=TRAIN,
                      eval_data=EVAL, test_data=EVAL, num_examples=4000)
        if on_trainer is not None:
            on_trainer(tr)
        for epoch in range(EPOCHS):
            for f in sorted(os.listdir(TRAIN)):
                tr.train_file(os.path.join(TRAIN, f), epoch_seed=epoch)
        res = tr.evaluate(EVAL)
        rows.append({"model_type": model_type, "auc": res["auc"],
                     "average_loss": res["average_loss"],
                     "prediction/mean": res["prediction/mean"],
                     "steps": tr.global_step, "seed": tr.seed,
                     "seconds": time.time() - t0})
        print(f"| {model_type} | {res['auc']:.4f} "
              f"| {res['average_loss']:.4f} | {res['prediction/mean']:.4f} |"
              f"  <!-- {time.time() - t0:.0f}s -->", flush=True)
        release(tr)
        del tr
    return rows


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="quality on the card")
    p.add_argument("--part", default="AB")
    p.add_argument("--device", default=None,
                   help="'cpu' trains on the host; default: the card")
    p.add_argument("--seed", type=int, default=None,
                   help="draws the weights and the shuffle orders "
                        "(default: the conf's tf_random_seed)")
    p.add_argument("--reference_data", default=None,
                   help="part A's data dir, with train/ and eval/ "
                        "(default, and where it does not exist: data/)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": device_name(device)}
    if "A" in args.part:
        out["part_a"] = part_a(device, args.reference_data,
                               seed=args.seed)
    if "B" in args.part:
        out["part_b"] = part_b(device, seed=args.seed)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
