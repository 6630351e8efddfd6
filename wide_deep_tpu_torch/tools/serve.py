"""Scoring-server CLI (the port's counterpart of tools/serve.py, the
tensorflow_model_server analog): load bundles onto the card and serve gRPC
(:port) and native TCP (:port + 1) until interrupted.

    python -m wide_deep_tpu_torch.tools.serve --model_base_path E \
        [--port 8500] [--transport both|tcp] [--device cpu]
    python -m wide_deep_tpu_torch.tools.serve --model_config models.yaml

``--transport tcp`` serves the TCP endpoint alone (still at :port + 1), for
a host without the ``grpc`` package; with the default ``both``, a missing
``grpc`` is an error.  ``--port 0`` binds free ports; the line printed once
serving gives the bound ones.  Flags default to conf/serving.yaml's server
section, from the conf dir ``--conf_dir`` (or WIDE_DEEP_CONF_DIR) names.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

from wide_deep_tpu_torch.config import Config


def main(argv: Optional[Sequence[str]] = None) -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--conf_dir",
                     default=os.environ.get("WIDE_DEEP_CONF_DIR"))
    conf_dir = pre.parse_known_args(argv)[0].conf_dir
    config = Config(conf_dir)
    server_conf = config.serving["server"]
    p = argparse.ArgumentParser(description="wide_deep_tpu_torch scoring "
                                            "server")
    p.add_argument("--conf_dir", default=conf_dir,
                   help="configuration directory (or WIDE_DEEP_CONF_DIR)")
    p.add_argument("--model_base_path", default=config.serving["model_dir"],
                   help="bundle root containing versioned subdirs")
    p.add_argument("--model_version", type=int, default=None,
                   help="explicit version (default: latest)")
    p.add_argument("--model_config", default=None,
                   help="YAML file serving MULTIPLE models (TF-Serving "
                        "--model_config_file analog): a `models:` list of "
                        "{name, base_path, version?, max_batch_size?}; "
                        "requests route by model_name, unpinned models "
                        "hot-reload independently.  Overrides "
                        "--model_base_path/--model_name/--model_version")
    p.add_argument("--port", type=int, default=server_conf["port"])
    p.add_argument("--transport", choices=["both", "tcp"], default="both",
                   help="both: gRPC :port and TCP :port+1; tcp: TCP "
                        ":port+1 alone (no grpc package needed)")
    p.add_argument("--model_name", default=server_conf["model_name"])
    p.add_argument("--max_batch_size", type=int,
                   default=server_conf["max_batch_size"])
    p.add_argument("--batch_timeout_micros", type=int,
                   default=server_conf["batch_timeout_micros"],
                   help="micro-batch window for coalescing concurrent "
                        "requests into one device call (0 = drain-only)")
    p.add_argument("--auth_token", default=server_conf.get("auth_token"),
                   help="shared-secret request auth (empty = open)")
    p.add_argument("--tls_cert", default=server_conf.get("tls_cert"),
                   help="PEM server certificate: enables TLS on both "
                        "transports (the native C++ client is plaintext — "
                        "front it with a TLS proxy)")
    p.add_argument("--tls_key", default=server_conf.get("tls_key"),
                   help="PEM server private key (required with --tls_cert)")
    p.add_argument("--tls_ca", default=server_conf.get("tls_ca"),
                   help="PEM CA bundle: require client certificates it "
                        "signed (mutual TLS)")
    p.add_argument("--device", default=None,
                   help="'cpu' serves from the host; default: the card")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from wide_deep_tpu_torch.serving.export import latest_version_dir
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)

    if args.model_config:
        import yaml
        with open(args.model_config) as f:
            spec = yaml.safe_load(f)
        entries = spec["models"] if isinstance(spec, dict) else spec
        if not entries:
            raise SystemExit(f"{args.model_config}: no models listed")
    else:
        entries = [{"name": args.model_name,
                    "base_path": args.model_base_path,
                    "version": args.model_version}]

    models, watch, served = [], {}, []
    for e in entries:
        if e.get("version") is not None:
            version_dir = os.path.join(e["base_path"], str(e["version"]))
        else:
            version_dir = latest_version_dir(e["base_path"])
            # watch for new versions unless one was pinned explicitly
            watch[e["name"]] = e["base_path"]
        m = ServingModel(version_dir,
                         int(e.get("max_batch_size", args.max_batch_size)),
                         e["name"],
                         batch_timeout_micros=args.batch_timeout_micros,
                         device=args.device)
        m.warmup()
        models.append(m)
        served.append(f"{e['name']} from {version_dir}")

    tcp_only = args.transport == "tcp"
    server = PredictorServer(
        models, port=None if tcp_only else args.port,
        tcp_port=args.port + 1 if args.port else 0,
        model_base_paths=watch, auth_token=args.auth_token or None,
        tls_cert=args.tls_cert or None, tls_key=args.tls_key or None,
        tls_ca=args.tls_ca or None)
    server.start()
    ports = (f"tcp :{server.tcp_port}" if tcp_only
             else f"grpc :{server.port}, tcp :{server.tcp_port}")
    print(f"serving {'; '.join(served)} ({ports})", flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        for m in server.models.values():
            m.close()


if __name__ == "__main__":
    main()
