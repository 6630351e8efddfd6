"""Training CLI (the port's counterpart of tools/train.py, after the
reference's python/train.py):

    python -m wide_deep_tpu_torch.tools.train [--device cpu] [--conf_dir D]
        [--model_dir M] [--train_epochs N] [--keep_train 0|1] ...

Modes (train.py:196-214 semantics): ``--dynamic_train 1`` trains a rolling
window over the sorted train files; a distributed launch trains without
interleaved eval; otherwise ``train_and_eval``.  keep_train=0 wipes
``<model_dir>/<model_type>`` first, 1 resumes from its latest checkpoint.
Ctrl-C saves a checkpoint, then exits 130.
"""

from __future__ import annotations

from typing import Optional, Sequence

from wide_deep_tpu_torch.tools.common import (base_parser,
                                              maybe_init_distributed,
                                              overrides_from, parse_args,
                                              setup, write_pid_file)


def main(argv: Optional[Sequence[str]] = None):
    """-> the Trainer, once training ended."""
    parser, _ = base_parser("wide_deep_tpu_torch training", argv)
    parser.add_argument("--distributed", type=int, default=0,
                        help="force multi-host mode (launcher sets env vars)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler Chrome trace of "
                             "training here")
    args = parse_args(parser, argv)
    config = setup(args)
    write_pid_file()
    dist = maybe_init_distributed(config, force=bool(args.distributed))

    from wide_deep_tpu_torch.training.loop import Trainer
    from wide_deep_tpu_torch.utils import profile_trace
    trainer = Trainer(config, model_type=args.model_type,
                      overrides=overrides_from(args), device=args.device)
    trainer.maybe_wipe_model_dir()
    try:
        with profile_trace(args.profile_dir):
            if dist.get("is_distribution"):
                # no interleaved eval in distributed mode (train.py:213-214)
                trainer.train()
            elif args.dynamic_train:
                trainer.dynamic_train()
            else:
                trainer.train_and_eval()
    except KeyboardInterrupt:
        # a graceful stop: keep the progress so keep_train resumes from it
        if trainer.params is not None and trainer.global_step > 0:
            print(f"interrupted at step {trainer.global_step}; "
                  "saving checkpoint...", flush=True)
            trainer.save()
        raise SystemExit(130)
    return trainer


if __name__ == "__main__":
    main()
