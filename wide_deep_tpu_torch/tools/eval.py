"""Evaluation CLI (the port's counterpart of tools/eval.py, after the
reference's python/eval.py): one evaluation pass over the test data from
the latest checkpoint, or from the one ``--checkpoint_path`` names
(``<model_dir>/<model_type>/<step>`` pins a step), printing the sorted
metric set.  Launched as N ranks (WDT_* variables, as the train CLI) it
evaluates on the mesh and prints one device's metrics.

    python -m wide_deep_tpu_torch.tools.eval [--device cpu]
        [--checkpoint_path P] [--test_data D] ...
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from wide_deep_tpu_torch.tools.common import (base_parser,
                                              maybe_init_distributed,
                                              overrides_from, parse_args,
                                              setup)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """-> the metrics it printed."""
    parser, _ = base_parser("wide_deep_tpu_torch evaluation", argv)
    args = parse_args(parser, argv)
    config = setup(args)
    dist = maybe_init_distributed(config, device=args.device)

    from wide_deep_tpu_torch.training.loop import Trainer
    trainer = Trainer(config, model_type=args.model_type,
                      overrides=overrides_from(args),
                      device=dist.get("device", args.device))
    results = trainer.evaluate(args.test_data,
                               checkpoint_path=args.checkpoint_path)
    print("-" * 72)
    for key in sorted(results):
        print(f"{key}: {results[key]}")
    return results


if __name__ == "__main__":
    main()
