"""HTTP forecast server over an exported artifact (stdlib only).

Port of `deepsphere_weather_tpu/cli/serve.py`. Endpoints:
    GET  /healthz         -> {"status": "ok"}
    GET  /v1/meta         -> artifact metadata JSON
    POST /v1/predict?n_steps=N
        body: npz with `history` [H, V, F] or [B, H, V, F] (physical
        units) and, when the artifact uses boundary conditions, `bc`
        [(B,) n_steps, n_input_k, V, F_bc]
        response: npz with `forecast` [(B,) N, n_out, V, F] (an ensemble
        artifact prepends the member axis) and `leadtimes` [N, n_out]

Single-sample requests go through the service's micro-batcher, so
concurrent clients are coalesced into one device batch.

Usage:
    python -m deepsphere_weather_torch.cli.serve \\
        --artifact artifacts/<model-name> [--host 127.0.0.1] [--port 8472]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                return self._json(200, {"status": "ok"})
            if path == "/v1/meta":
                return self._json(200, service.meta)
            return self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/predict":
                return self._json(404, {"error": f"unknown path {url.path}"})
            try:
                n_steps = int(parse_qs(url.query).get("n_steps", ["1"])[0])
                length = int(self.headers.get("Content-Length", "0"))
                payload = np.load(io.BytesIO(self.rfile.read(length)),
                                  allow_pickle=False)
                history = payload["history"]
                bc = payload["bc"] if "bc" in payload.files else None
                if history.ndim == 3:     # micro-batched path
                    forecast = service.submit(history, n_steps, bc).result()
                else:
                    forecast = service.predict(history, n_steps, bc)
                buf = io.BytesIO()
                np.savez_compressed(buf, forecast=forecast,
                                    leadtimes=service.leadtimes(n_steps))
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (ValueError, KeyError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(artifact, host: str = "127.0.0.1", port: int = 8472,
          block: bool = True):
    """Start the server; returns (server, service). block=False runs it on
    a daemon thread (tests and embedding applications); the caller then
    stops it with server.shutdown()."""
    from ..serve import ForecastService

    service = ForecastService.from_dir(artifact)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    if block:
        m = service.meta
        print(f"serving {artifact} on http://{host}:{server.server_port} "
              f"(batch {m['batch_size']}, block {m['block_size']}, "
              f"{m['n_node']} nodes)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            service.close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service


def cli():
    p = argparse.ArgumentParser(description="HTTP forecast server")
    p.add_argument("--artifact", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8472)
    a = p.parse_args()
    serve(a.artifact, host=a.host, port=a.port)


if __name__ == "__main__":
    cli()
