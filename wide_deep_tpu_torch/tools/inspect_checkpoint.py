"""Checkpoint inspector CLI (the port's counterpart of
tools/inspect_checkpoint.py, after the reference's
python/lib/utils/inspect_checkpoint.py:31-60): list the leaves (name, shape,
dtype) of one of the port's checkpoints, optionally filtered by name and
with their values.  Reads files only: no card needed.

    python -m wide_deep_tpu_torch.tools.inspect_checkpoint
        --model_dir <model_dir>/<model_type> [--step N]
        [--tensor_name SUBSTRING] [--print_values]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """-> {name: tensor or int} of the leaves it listed."""
    p = argparse.ArgumentParser(
        description="inspect a wide_deep_tpu_torch checkpoint")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--tensor_name", default=None,
                   help="substring filter on tensor names")
    p.add_argument("--print_values", action="store_true")
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.training.checkpoint import inspect_checkpoint
    return inspect_checkpoint(args.model_dir, step=args.step,
                              tensor_name=args.tensor_name,
                              print_values=args.print_values)


if __name__ == "__main__":
    main()
