"""Export CLI (the port's counterpart of tools/export.py, after the
reference's export_savedmodel.py): write a versioned serving bundle from the
latest (or an explicit) checkpoint of the port's trainer.

    python -m wide_deep_tpu_torch.tools.export --model_dir M --export_dir E \
        [--checkpoint_path M/wide_deep/<step>] [--model_version N]

Flags default to conf/serving.yaml's SavedModel section and train.yaml's
model_dir, from the conf dir ``--conf_dir`` (or WIDE_DEEP_CONF_DIR) names.
Export runs on the host: it reads the checkpoint and writes files.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from wide_deep_tpu_torch.config import Config


def main(argv: Optional[Sequence[str]] = None) -> str:
    """-> the bundle's version dir."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--conf_dir",
                     default=os.environ.get("WIDE_DEEP_CONF_DIR"))
    conf_dir = pre.parse_known_args(argv)[0].conf_dir
    config = Config(conf_dir)
    serving = config.serving
    p = argparse.ArgumentParser(description="export a serving bundle")
    p.add_argument("--conf_dir", default=conf_dir,
                   help="configuration directory (or WIDE_DEEP_CONF_DIR)")
    p.add_argument("--export_dir", default=serving["model_dir"],
                   help="bundle root (versioned subdirs created inside)")
    p.add_argument("--model_type", default=serving["model_type"])
    p.add_argument("--model_dir", default=config.train["model_dir"],
                   help="training checkpoint root")
    p.add_argument("--checkpoint_path", default=serving["checkpoint_path"])
    p.add_argument("--model_version", type=int,
                   default=serving["model_version"])
    p.add_argument("--as_text", type=int, default=int(serving["as_text"]))
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.serving.export import export_savedmodel
    path = export_savedmodel(
        config, args.export_dir, model_type=args.model_type,
        checkpoint_path=args.checkpoint_path,
        model_version=args.model_version, as_text=bool(args.as_text),
        model_dir=args.model_dir)
    print(f"exported bundle: {path}", flush=True)
    return path


if __name__ == "__main__":
    main()
