"""Serving client CLI (the port's counterpart of tools/client.py, after the
reference's tensorflow_serving/client.py): score TSV rows against a running
server, print its models, or run the threaded load test.

    python -m wide_deep_tpu_torch.tools.client --server_port 8500 \
        --data_file data/pred/pred1 --num_rows 3 [--transport grpc|tcp]
    python -m wide_deep_tpu_torch.tools.client --server_port 8500 --status
    python -m wide_deep_tpu_torch.tools.client --server_port 8500 \
        --data_file data/pred/pred1 --load_test [--concurrency 8]

The server's TCP endpoint is at its gRPC port + 1 unless it was started
otherwise; the C++ client speaks TCP only.  Prints
``<i>\\tclass: <c>\\tprobability: <p>`` a row, as the C++ client does.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """-> the response, the status or the load-test stats."""
    p = argparse.ArgumentParser(description="wide_deep_tpu_torch serving "
                                            "client")
    p.add_argument("--server_host", default="localhost")
    p.add_argument("--server_port", type=int, default=8500)
    p.add_argument("--transport", choices=["grpc", "tcp"], default="grpc")
    p.add_argument("--model_name", default="wide_deep")
    p.add_argument("--status", action="store_true",
                   help="print served models + versions and exit "
                        "(TF-Serving GetModelStatus analog)")
    p.add_argument("--data_file", default=None)
    p.add_argument("--num_rows", type=int, default=10)
    p.add_argument("--load_test", action="store_true",
                   help="run the concurrency load harness instead")
    p.add_argument("--num_requests", type=int, default=100)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--tls_ca", default=None,
                   help="PEM root cert: connect over TLS, verify the server")
    p.add_argument("--tls_cert", default=None,
                   help="PEM client certificate (mutual TLS)")
    p.add_argument("--tls_key", default=None,
                   help="PEM client key (with --tls_cert)")
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.serving.client import (PredictorClient,
                                                    TcpPredictorClient,
                                                    do_inference)
    rows = []
    if not args.status:
        if not args.data_file:
            p.error("--data_file is required unless --status")
        with open(args.data_file, encoding="utf-8") as f:
            rows = [line.rstrip("\n") for line in f if line.strip()]
        rows = rows[:max(args.num_rows, 1)] if not args.load_test else rows

    cls = PredictorClient if args.transport == "grpc" else TcpPredictorClient
    client = cls(args.server_host, args.server_port, args.model_name,
                 tls_ca=args.tls_ca,
                 tls_cert=args.tls_cert, tls_key=args.tls_key)
    try:
        if args.status:
            out = client.status()
            for m in out["models"]:
                print("\t".join(f"{k}: {v}" for k, v in sorted(m.items())))
        elif args.load_test:
            out = do_inference(client, rows, args.num_requests,
                               args.concurrency)
            for k, v in sorted(out.items()):
                print(f"{k}: {v:.3f}" if isinstance(v, float)
                      else f"{k}: {v}")
        else:
            out = client.predict(rows)
            for i, (score, cid) in enumerate(zip(out["scores"],
                                                 out["class_ids"])):
                print(f"{i}\tclass: {cid}\tprobability: {score[cid]:.6f}")
    finally:
        client.close()
    return out


if __name__ == "__main__":
    main()
