"""Serving wire protocol, shared by the gRPC and raw-TCP transports (the
port's copy of the JAX package's ``serving/protocol.py``, byte for byte on
the wire).

The reference served via TF-Serving's PredictionService (its
python/tensorflow_serving/client.py:192-225 and client.cc).
Our scoring server speaks the same *logical* contract — TSV rows in, per-row
scores out — over two transports:

* gRPC generic method ``/wdt.Predictor/Predict`` (Python client; no protoc
  needed — request/response bytes use the JSON encoding below).
* length-prefixed TCP frames (native C++ client, cpp/serving_client.cc):
  ``'WDTS' <u32 LE payload length> <payload>`` each way.

Payloads are UTF-8 JSON:
  request : {"model_name": str, "rows": [tsv_row_str, ...], "signature": str}
  response: {"model_name": str, "scores": [[p_class0, p_class1, ...], ...],
             "class_ids": [int, ...]}  or  {"error": str}
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List

MAGIC = b"WDTS"
GRPC_METHOD = "/wdt.Predictor/Predict"
MAX_FRAME = 64 << 20


def encode_request(rows: List[str], model_name: str = "wide_deep",
                   signature: str = "serving_default",
                   auth_token: str = None) -> bytes:
    req = {"model_name": model_name, "rows": rows, "signature": signature}
    if auth_token:
        req["auth_token"] = auth_token
    return json.dumps(req).encode("utf-8")


def encode_status_request(auth_token: str = None) -> bytes:
    """Model-status query (TF-Serving GetModelStatus analog): the server
    answers {"models": [{name, version, state, ...}]} without scoring."""
    req: Dict[str, Any] = {"op": "status"}
    if auth_token:
        req["auth_token"] = auth_token
    return json.dumps(req).encode("utf-8")


def decode_request(payload: bytes) -> Dict[str, Any]:
    return json.loads(payload.decode("utf-8"))


def encode_response(resp: Dict[str, Any]) -> bytes:
    return json.dumps(resp).encode("utf-8")


def decode_response(payload: bytes) -> Dict[str, Any]:
    return json.loads(payload.decode("utf-8"))


# ----------------------------------------------------------------- TCP frame
def send_frame(sock: socket.socket, payload: bytes) -> None:
    # enforce the receiver's bound HERE: an oversized frame would be
    # dropped by the peer's recv_frame with no actionable client-side
    # error (and a >= 4 GiB payload would die in struct.pack mid-send,
    # desyncing the stream)
    if len(payload) > MAX_FRAME:
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME "
            f"({MAX_FRAME}); split the request into smaller batches")
    sock.sendall(MAGIC + struct.pack("<I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 8)
    if header[:4] != MAGIC:
        raise IOError("bad frame magic")
    (length,) = struct.unpack("<I", header[4:])
    if length > MAX_FRAME:
        raise IOError("frame too large")
    return _recv_exact(sock, length)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise IOError("connection closed mid-frame")
        buf += chunk
    return buf
