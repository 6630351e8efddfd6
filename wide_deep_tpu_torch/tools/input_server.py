"""The input-service loader (features/input_service.py): iterates the train
data at the GLOBAL batch size, emits every per-shard kernel plan with the
C++ loader, and serves each rank its slice over framed TCP.

    python -m wide_deep_tpu_torch.tools.input_server --port 8600 \
        --n_devices 2 --n_procs 2 [--conf_dir D] [--train_data F] \
        [--batch_size 25600]

The port's counterpart of tools/input_server.py.  Point the ranks at it with
train.yaml ``distribution.input_service: "host:port"``.  The plan it emits
is the ranks' plan bit for bit: both sides build it through
training/loop.build_training_plan from the same conf directory, here with
``global_batch_input=True``; ``--n_devices`` / ``--n_procs`` describe the
ranks (one table shard each).  A host-side process: it takes no card.
``--port 0`` binds a free port; the line printed names the one bound.
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
from typing import Optional, Sequence


def build_server(config, train_conf, args):
    """The InputServer of ``args`` (not started) and its plan."""
    from wide_deep_tpu_torch.features.input_service import (
        InputServer, data_digest, stream_fingerprint)
    from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                       default_transformer)
    from wide_deep_tpu_torch.training.loop import build_training_plan

    plan = build_training_plan(
        config, train_conf, args.model_type, args.n_devices,
        n_procs=args.n_procs, global_batch_input=True)
    seed = int(config.runconfig["tf_random_seed"])
    pos_w = train_conf.get("pos_sample_loss_weight")
    neg_w = train_conf.get("neg_sample_loss_weight")
    transformer = default_transformer(
        plan, args.n_classes, pos_weight=pos_w, neg_weight=neg_w,
        num_parallel_calls=train_conf.get("num_parallel_calls"))
    with_cnn = (bool(config.model.get("cnn_use_flag"))
                and args.image_train_data)

    def dataset_factory(path, mode, epoch_seed):
        # Trainer._dataset with one shard: the service is the one host
        # that sees the global batch
        kwargs = dict(n_classes=args.n_classes, pos_weight=pos_w,
                      neg_weight=neg_w,
                      shuffle_buffer=int(train_conf["num_examples"]),
                      seed=seed + int(epoch_seed), transformer=transformer)
        if with_cnn:
            from wide_deep_tpu_torch.features.image import ImageCsvDataset
            from wide_deep_tpu_torch.models.cnn import CnnSpec
            cs = CnnSpec.from_model_conf(config.model)
            return ImageCsvDataset(
                plan, path, args.image_train_data, mode, args.batch_size,
                height=cs.height, width=cs.width, channels=cs.channels,
                **kwargs)
        return CsvDataset(plan, path, mode, args.batch_size, **kwargs)

    fingerprint = stream_fingerprint(
        seed, args.batch_size, args.n_classes, plan.scatter_shards,
        args.n_procs, pos_weight=pos_w, neg_weight=neg_w,
        model_type=args.model_type,
        shuffle_buffer=int(train_conf["num_examples"]))

    def digest_with_mode(path):
        """data_digest plus the dataset's iteration path (the fast and the
        streaming paths give different orders)."""
        ds = dataset_factory(path, "train", 0)
        fast = getattr(ds, "_fast_path_ok", lambda: False)()
        return f"{data_digest(path)}-{'fast' if fast else 'stream'}"

    server = InputServer(dataset_factory, n_procs=args.n_procs,
                         scatter_shards=plan.scatter_shards, port=args.port,
                         proc_start=args.proc_start,
                         proc_count=args.proc_count,
                         fingerprint=fingerprint,
                         data_digest_fn=digest_with_mode)
    return server, plan


def main(argv: Optional[Sequence[str]] = None):
    """Serve until interrupted."""
    from wide_deep_tpu_torch.config import Config
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--conf_dir",
                     default=os.environ.get("WIDE_DEEP_CONF_DIR"))
    conf_dir = pre.parse_known_args(argv)[0].conf_dir
    config = Config(conf_dir)
    train_conf = dict(config.train)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conf_dir", default=conf_dir)
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--n_devices", type=int, required=True,
                   help="table shards of the training mesh (ranks)")
    p.add_argument("--n_procs", type=int, required=True,
                   help="training processes (ranks)")
    p.add_argument("--proc_start", type=int, default=0)
    p.add_argument("--proc_count", type=int, default=None)
    p.add_argument("--model_type", default=train_conf["model_type"])
    p.add_argument("--batch_size", type=int,
                   default=train_conf["batch_size"],
                   help="GLOBAL batch size (must match the ranks')")
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--train_data", default=train_conf.get("train_data"))
    p.add_argument("--pack_budget", default=None)
    p.add_argument("--image_train_data",
                   default=train_conf.get("image_train_data"))
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    train_conf["batch_size"] = args.batch_size
    if args.train_data:
        train_conf["train_data"] = args.train_data
    if args.pack_budget is not None:
        train_conf["pack_budget"] = (int(args.pack_budget)
                                     if args.pack_budget.isdigit()
                                     else args.pack_budget)
    server, plan = build_server(config, train_conf, args)
    server.start()
    print(f"input service on :{server.port} (procs [{server.proc_start}, "
          f"{server.proc_start + server.proc_count}) of {args.n_procs}, "
          f"{plan.scatter_shards} table shards)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
