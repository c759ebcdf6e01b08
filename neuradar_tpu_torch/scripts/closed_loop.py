"""Closed-loop simulation server of the port: a driving simulator asks it over HTTP for camera
renders of a trained run's scene at any ego pose and time, and edits the actors (port of the JAX
package's scripts/closed_loop.py; the standard library's HTTP server, the same JSON API):

  POST /render  {"pose": [[3 x 4]], "time": t, "hw": [H, W]}  -> PNG bytes
  GET  /actors                                               -> {"trajectories": [...]}
  POST /actors  {"index": i, "lateral": dy, "longitudinal": dx, "rotation": r, "remove": false}
                                                             -> the actor edit of later renders
  GET  /info                                                 -> scene metadata

    python -m neuradar_tpu_torch.scripts.closed_loop --load-config <run dir> [--port 8000] [--device cpu]

Requests are served on threads; one lock serializes the renders on the device and the edits.
It renders on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from neuradar_tpu_torch.model_components.dynamic_actors import ActorEdits
from neuradar_tpu_torch.utils.tb_writer import encode_png


class ClosedLoopState:
    """A loaded pipeline, the current actor edit and the lock around both."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.edits = ActorEdits()
        self.lock = threading.Lock()

    def render(self, pose, time_s, hw) -> np.ndarray:
        c2w = np.asarray(pose, np.float32).reshape(3, 4)
        with self.lock:
            return self.pipeline.render_pose(c2w, hw=tuple(int(x) for x in hw), time_s=float(time_s),
                                             actor_edits=self.edits)

    def set_edits(self, d: dict) -> None:
        edits = ActorEdits(lateral=float(d.get("lateral", 0.0)), longitudinal=float(d.get("longitudinal", 0.0)),
                           rotation=float(d.get("rotation", 0.0)), index=int(d.get("index", -1)),
                           remove=bool(d.get("remove", False)))
        with self.lock:
            self.edits = edits

    def info(self) -> dict:
        out = self.pipeline.outputs
        return {"duration": out.duration, "image_size": list(out.image_size), "num_actors": len(out.trajectories),
                "sensors": out.sensor_idx_to_name}

    def actors(self) -> dict:
        return {"trajectories": [{"timestamps": np.asarray(t["timestamps"]).tolist(), "dims": np.asarray(t["dims"]).tolist()}
                                 for t in self.pipeline.outputs.trajectories]}


def serve(state: ClosedLoopState, port: int = 8000, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The server, bound and not yet serving (``serve_forever``); port 0 takes a free port
    (``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/info"):
                self._send(200, "application/json", json.dumps(state.info()).encode())
            elif self.path.startswith("/actors"):
                self._send(200, "application/json", json.dumps(state.actors()).encode())
            else:
                self._send(404, "text/plain", b"endpoints: /info /actors /render")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            if self.path.startswith("/render"):
                try:
                    rgb = state.render(req["pose"], req.get("time", 0.0), req.get("hw", [96, 156]))
                    self._send(200, "image/png", encode_png(rgb))
                except Exception as e:  # noqa: BLE001 - the client gets the error
                    self._send(500, "text/plain", str(e).encode())
            elif self.path.startswith("/actors"):
                state.set_edits(req)
                self._send(200, "application/json", b'{"ok": true}')
            else:
                self._send(404, "text/plain", b"not found")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from neuradar_tpu_torch.scripts.render import load_pipeline

    server = serve(ClosedLoopState(load_pipeline(args.load_config, args.device)), args.port)
    print(f"[closed_loop] serving on :{server.server_address[1]}")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
