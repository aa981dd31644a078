"""HTTP inference endpoint: POST a volume, get the labelmap back.

Counterpart of ``runet_tpu/infer/http_serve.py``, stdlib only
(``http.server``). For PACS gateways and orchestrators that send a volume
and want the labels on the same connection.

Endpoints:

  GET  /healthz      -> 200 JSON {status, device, cascade, num_classes}
  POST /v1/predict   -> body: ``.nii`` or ``.nii.gz`` bytes (gzip sniffed
                        by magic). Response: gzipped NIfTI-1 labelmap at
                        the native grid (application/gzip), with the JSON
                        report (latency, per-structure volumetry) in the
                        ``X-Runet-Report`` header.
  POST /v1/report    -> same body; the JSON report only.

One device serves every request, so predictions go through one lock; the
server's threads still overlap one request's parse and response gzip with
the device work of another.

    service = InferenceService(fine, coarse, cascade)        # on the card
    service = InferenceService(fine, coarse, device="cpu")   # plain path
    server = make_server(service, "127.0.0.1", 8080)
    server.serve_forever()
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from runet_tpu_torch import resolve_device
from runet_tpu_torch.config import CascadeConfig
from runet_tpu_torch.eval.surface import volumetry
from runet_tpu_torch.infer.cascade import predict_case, predict_volume
from runet_tpu_torch.io.nifti import volume_from_bytes, volume_to_bytes

# A KiTS19-scale int16 volume gzips to ~30-80 MB; f32 exports run larger.
# Reject clearly absurd bodies before buffering them.
MAX_BODY_BYTES = 1 << 31  # 2 GiB


class InferenceService:
    """Owns the model bundles, the device (CUDA unless named) and the lock
    that serializes predictions on it."""

    def __init__(self, fine, coarse=None, cascade=None, postprocess: bool = True, device=None):
        self.fine = fine
        self.coarse = coarse
        self.cascade = cascade if cascade is not None else CascadeConfig()
        self.postprocess = postprocess
        self.device = resolve_device(device)
        self._lock = threading.Lock()

    def predict(self, vol) -> tuple[np.ndarray, dict]:
        """Volume -> (native-grid uint8 labelmap, JSON-safe report)."""
        t0 = time.monotonic()
        with self._lock:
            if self.coarse is not None:
                pred = predict_case(self.coarse, self.fine, vol.data, vol.spacing, self.cascade,
                                    postprocess=self.postprocess, device=self.device)
            else:
                pred = predict_volume(self.fine, vol.data, vol.spacing, device=self.device)
        report = {
            "latency_s": round(time.monotonic() - t0, 3),
            "shape": list(vol.data.shape),
            "spacing_mm": [float(s) for s in vol.spacing],
            **volumetry(pred, vol.spacing, self.fine.num_classes),
        }
        return pred, report

    def health(self) -> dict:
        dev = self.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
        return {"status": "ok", "device": name, "cascade": self.coarse is not None,
                "num_classes": self.fine.num_classes}


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response below sets Content-Length.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; the report carries the signal
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, service.health())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def _read_volume(self):
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                self._send_json(411, {"error": "Content-Length required"})
                return None
            if n > MAX_BODY_BYTES:
                self._send_json(413, {"error": f"body {n} bytes > {MAX_BODY_BYTES}"})
                return None
            raw = self.rfile.read(n)
            try:
                return volume_from_bytes(raw)
            except Exception as e:
                self._send_json(400, {"error": f"unparseable NIfTI body: {e!r}"})
                return None

        def do_POST(self):
            if self.path not in ("/v1/predict", "/v1/report"):
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            vol = self._read_volume()
            if vol is None:
                return
            try:
                pred, report = service.predict(vol)
            except Exception as e:
                self._send_json(500, {"error": f"prediction failed: {e!r}"})
                return
            if self.path == "/v1/report":
                self._send_json(200, report)
                return
            body = volume_to_bytes(pred, vol.spacing, vol.affine, gz=True)
            self._send(200, body, "application/gzip", extra=(
                ("X-Runet-Report", json.dumps(report)),
                ("Content-Disposition", 'attachment; filename="labels.nii.gz"'),
            ))

    return Handler


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """Build (but do not start) the server; the caller owns its lifetime.
    ``port=0`` binds an ephemeral port (read ``server_address``)."""
    return ThreadingHTTPServer((host, port), _make_handler(service))
