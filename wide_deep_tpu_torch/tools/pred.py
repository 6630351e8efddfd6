"""Prediction CLI (the port's counterpart of tools/pred.py, after the
reference's python/pred.py): one line per row of unlabeled TSV data,
``<i>\tclass: <c>\tprobability: <p>``, from the latest checkpoint.

    python -m wide_deep_tpu_torch.tools.pred [--device cpu] [--data_dir D]
"""

from __future__ import annotations

from typing import Optional, Sequence

from wide_deep_tpu_torch.tools.common import (base_parser, overrides_from,
                                              parse_args, setup)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """-> the number of rows it printed."""
    parser, _ = base_parser("wide_deep_tpu_torch prediction", argv)
    parser.add_argument("--data_dir", default=None,
                        help="prediction data (defaults to test_data)")
    args = parse_args(parser, argv)
    config = setup(args)

    from wide_deep_tpu_torch.training.loop import Trainer
    trainer = Trainer(config, model_type=args.model_type,
                      overrides=overrides_from(args), device=args.device)
    n = 0
    for i, pred in enumerate(trainer.predict(args.data_dir or args.test_data)):
        class_id = int(pred["class_ids"])
        prob = float(pred["probabilities"][class_id])
        print(f"{i}\tclass: {class_id}\tprobability: {prob:.6f}")
        n += 1
    return n


if __name__ == "__main__":
    main()
