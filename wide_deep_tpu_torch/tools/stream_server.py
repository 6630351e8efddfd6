"""Replay a TSV file as a newline-delimited TCP stream: the producer side
of the streaming path (features/stream.py), for driving
``Trainer.train_stream`` end to end; a deployment points the trainer at its
event stream instead.

    python -m wide_deep_tpu_torch.tools.stream_server \
        --data_file data/train/train1 --port 19000 [--rows_per_s 5000] [--loop]

The port's counterpart of tools/stream_server.py.  A host-side producer: it
runs no model and takes no ``--device``.  ``--port 0`` binds a free port;
the line printed names the one bound.  Serves one client, then exits.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_file", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=19000)
    p.add_argument("--rows_per_s", type=float, default=None)
    p.add_argument("--loop", action="store_true")
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.features.stream import serve_file
    srv, t = serve_file(args.data_file, args.host, args.port,
                        rows_per_s=args.rows_per_s, loop=args.loop)
    print(f"streaming {args.data_file} on {args.host}:"
          f"{srv.getsockname()[1]}", flush=True)
    t.join()


if __name__ == "__main__":
    main()
