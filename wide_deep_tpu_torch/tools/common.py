"""Shared plumbing of the port's train / eval / pred CLIs (the port's copy of
the JAX package's tools/common.py, after the reference's train.py:24-62):
the YAML conf supplies every default, the command line overrides it, and
``--device cpu`` runs on the host where the default is the card."""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from wide_deep_tpu_torch.config import Config


def base_parser(description: str, argv: Optional[Sequence[str]] = None
                ) -> tuple[argparse.ArgumentParser, Config]:
    """The parser whose defaults come from the conf dir named by
    ``--conf_dir`` (or WIDE_DEEP_CONF_DIR), and that Config.  ``--conf_dir``
    is scanned first: ``overrides_from`` feeds every default back into the
    Trainer, so defaults read from another conf dir would overwrite the
    named one's train.yaml."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--conf_dir",
                     default=os.environ.get("WIDE_DEEP_CONF_DIR"))
    conf_dir = pre.parse_known_args(argv)[0].conf_dir
    config = Config(conf_dir)
    t = config.train
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--conf_dir", default=conf_dir,
                   help="configuration directory (or WIDE_DEEP_CONF_DIR)")
    p.add_argument("--model_dir", default=t["model_dir"])
    p.add_argument("--model_type", default=t["model_type"],
                   choices=["wide", "deep", "wide_deep"])
    p.add_argument("--train_data", default=t["train_data"])
    p.add_argument("--eval_data", default=t["eval_data"])
    p.add_argument("--test_data", default=t["test_data"])
    p.add_argument("--image_train_data", default=t["image_train_data"],
                   help="TFRecord of the images paired with the train rows "
                        "(the CNN arm, model.yaml cnn_use_flag)")
    p.add_argument("--image_eval_data", default=t["image_eval_data"])
    p.add_argument("--image_test_data", default=t["image_test_data"])
    p.add_argument("--batch_size", type=int, default=t["batch_size"])
    p.add_argument("--train_epochs", type=int, default=t["train_epochs"])
    p.add_argument("--epochs_per_eval", type=int, default=t["epochs_per_eval"])
    p.add_argument("--keep_train", type=int, default=int(t["keep_train"]))
    p.add_argument("--dynamic_train", type=int,
                   default=int(t["dynamic_train"]))
    p.add_argument("--checkpoint_path", default=t["checkpoint_path"])
    p.add_argument("--pos_sample_loss_weight", type=float,
                   default=t["pos_sample_loss_weight"])
    p.add_argument("--neg_sample_loss_weight", type=float,
                   default=t["neg_sample_loss_weight"])
    p.add_argument("--eval_every_n_steps", type=int,
                   default=int(t.get("eval_every_n_steps") or 0),
                   help="interleave a full eval pass every N train steps "
                        "(0 = off)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs on the host; default: the card")
    return p, config


def parse_args(parser: argparse.ArgumentParser,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Known arguments; unknown ones are ignored with a warning, never
    silently (a mistyped flag would otherwise run under the conf's
    defaults)."""
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"WARNING: ignoring unrecognized arguments: {unknown}",
              flush=True)
    return args


def setup(args) -> Config:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return Config(args.conf_dir) if args.conf_dir else Config()


def overrides_from(args) -> dict:
    return dict(
        model_dir=args.model_dir, model_type=args.model_type,
        train_data=args.train_data, eval_data=args.eval_data,
        test_data=args.test_data, batch_size=args.batch_size,
        train_epochs=args.train_epochs, epochs_per_eval=args.epochs_per_eval,
        keep_train=bool(args.keep_train),
        dynamic_train=bool(args.dynamic_train),
        checkpoint_path=args.checkpoint_path,
        pos_sample_loss_weight=args.pos_sample_loss_weight,
        neg_sample_loss_weight=args.neg_sample_loss_weight,
        image_train_data=args.image_train_data,
        image_eval_data=args.image_eval_data,
        image_test_data=args.image_test_data,
        eval_every_n_steps=args.eval_every_n_steps)


def maybe_init_distributed(config: Config, force: bool = False,
                           device=None) -> dict:
    """The distribution settings: train.yaml's, overridden by the launcher's
    WDT_COORDINATOR / WDT_NUM_PROCESSES / WDT_PROCESS_INDEX (the JAX
    launcher's variables, scripts/run_distributed.sh).  More than one
    process: this one joins ``torch.distributed`` as rank
    ``process_index`` at ``tcp://<coordinator>``, on the card and backend
    parallel/mesh.placement picks (``device="cpu"``: the host); the
    Trainer then lays the ranks out as train.yaml's mesh."""
    dist = dict(config.distribution)
    if os.environ.get("WDT_COORDINATOR"):
        dist["is_distribution"] = True
        dist["coordinator"] = os.environ["WDT_COORDINATOR"]
        # each variable falls back to the YAML value when only some of
        # them are exported
        dist["num_processes"] = int(
            os.environ.get("WDT_NUM_PROCESSES")
            or dist.get("num_processes") or 1)
        dist["process_index"] = int(
            os.environ.get("WDT_PROCESS_INDEX")
            or dist.get("process_index") or 0)
    if force:
        dist["is_distribution"] = True
    n = int(dist.get("num_processes") or 1)
    if dist.get("is_distribution") and n > 1:
        from wide_deep_tpu_torch.parallel.mesh import init_distributed
        coord = str(dist["coordinator"])
        init_method = coord if "://" in coord else f"tcp://{coord}"
        dev, backend = init_distributed(int(dist.get("process_index") or 0),
                                        n, init_method, device)
        dist["device"], dist["backend"] = str(dev), backend
    return dist


def write_pid_file():
    os.makedirs("logs", exist_ok=True)
    with open(os.path.join("logs", "train.pid"), "w") as f:
        f.write(str(os.getpid()))
