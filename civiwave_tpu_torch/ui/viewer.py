"""Interactive viewer: a self-contained web front-end over InteractiveSession.

Port of :mod:`civiwave_tpu.ui.viewer`, the reference's redesign of the
reference engine's GLFW/ImGui/Vulkan viewer (src/ui/viewer.cpp:1081-3539)
as a tiny HTTP server (the standard library's ``http.server``) and a
single-file WebGL2 page (``ui/viewer.html``, the JAX package's page byte
for byte; no external assets, works in any browser and over SSH
tunnels): the browser owns camera orbit/zoom/pan, vertex picking,
deformation scaling and the von Mises color ramp (viewer.cpp:130-148), and
every "solve" round-trips one Newmark frame on the simulation's device
through :class:`~civiwave_tpu_torch.ui.session.InteractiveSession` —
restore baseline, inject the picked point load, step, recolor
(SimulationBackend::solve, viewer.cpp:255-278).

Feature parity with the reference viewer panel (viewer.cpp:2428-2634):
mesh stats, run/auto-run solve, deformation magnitude (log slider),
wireframe toggle, stress-vector controls (anchor vertex via Ctrl+click
picking, yaw/pitch direction, load magnitude, arrow overlay), paused-mode
tolerance switch, reset, live PCG telemetry.

Wire protocol (all localhost):
    GET  /        -> the embedded HTML/JS page
    GET  /mesh    -> JSON header line + positions (N,3) f32 + tris (F,3) i32
    POST /solve   -> {enabled, anchor, direction, magnitude, paused}
                     -> JSON telemetry line + u (N,3) f32 + vm (N,) f32
    POST /reset   -> restores the captured baseline

Run (the simulation on the card unless ``--device cpu``)::

    python -m civiwave_tpu_torch.ui.viewer scenario.yaml --port 8787 \
        --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..utils.errors import CwfError
from .session import InteractiveSession, PointLoadRequest

_HTML_PATH = os.path.join(os.path.dirname(__file__), "viewer.html")


class ViewerBackend:
    """Owns the simulation session + geometry; serializes solves."""

    def __init__(self, simulation) -> None:
        simulation.ensure_host_mesh()
        self.sim = simulation
        self.session = InteractiveSession(simulation)
        self._lock = threading.Lock()

        from ..post.snapshot import _surface_triangles

        mesh = simulation.mesh
        self.positions = np.asarray(mesh.node_positions, np.float32)
        self.triangles = np.asarray(_surface_triangles(mesh), np.int32)
        self.node_count = mesh.node_count
        self.element_count = mesh.element_count

    def mesh_blob(self):
        header = {
            "nodes": int(self.node_count),
            "elements": int(self.element_count),
            "tris": int(len(self.triangles)),
            "structured": bool(getattr(self.sim, "structured", False)),
            "dt": float(self.sim.stepper.current_dt),
        }
        return header, self.positions.tobytes() + self.triangles.tobytes()

    def solve(self, params: dict):
        request = PointLoadRequest(
            enabled=bool(params.get("enabled", False)),
            anchor=int(params.get("anchor", 0)),
            direction=tuple(params.get("direction", (0.0, 0.0, -1.0))),
            magnitude_newtons=float(params.get("magnitude", 0.0)),
        )
        with self._lock:
            t0 = time.perf_counter()
            telemetry, derived = self.session.solve(
                request, paused_mode=bool(params.get("paused", False))
            )
            u = self.sim.stepper.displacement()
            solve_ms = (time.perf_counter() - t0) * 1e3
        vm = derived.node_von_mises[: self.node_count]
        header = {
            "iterations": telemetry.pcg_iterations,
            "residual": telemetry.pcg_residual_norm,
            "converged": telemetry.pcg_converged,
            "dt": telemetry.time_step,
            "solve_ms": round(solve_ms, 2),
            "vm_max": float(vm.max()) if vm.size else 0.0,
            "u_max": float(np.abs(u).max()) if u.size else 0.0,
        }
        blob = (
            np.ascontiguousarray(u[: self.node_count], np.float32).tobytes()
            + np.ascontiguousarray(vm, np.float32).tobytes()
        )
        if params.get("overlay"):
            # anticipatory directional stress overlay with auto-derived
            # exponential falloff (viewer.cpp:2940-2999) appended as a
            # third (N,) f32 array
            from .session import display_stress_overlay

            display, falloff = display_stress_overlay(
                self.positions[: self.node_count],
                vm,
                request,
                magnitude_scale=float(params.get("magnitude_scale", 1.0)),
            )
            header["overlay"] = True
            header["falloff"] = round(float(falloff), 4)
            header["overlay_max"] = float(display.max()) if display.size else 0.0
            blob += np.ascontiguousarray(display, np.float32).tobytes()
        return header, blob

    def reset(self) -> None:
        with self._lock:
            self.session.reset()


def _make_handler(backend: ViewerBackend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, status, body: bytes, content_type: str, header=None):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if header is not None:
                self.send_header("X-Civiwave", json.dumps(header))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                page = open(_HTML_PATH, "rb").read()
                self._send(200, page, "text/html; charset=utf-8")
            elif self.path == "/mesh":
                header, blob = backend.mesh_blob()
                self._send(200, blob, "application/octet-stream", header)
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) if length else b"{}"
            if self.path == "/solve":
                try:
                    params = json.loads(raw or b"{}")
                    header, blob = backend.solve(params)
                except Exception as exc:  # surface solver errors to the UI
                    self._send(
                        500, str(exc).encode(), "text/plain"
                    )
                    return
                self._send(200, blob, "application/octet-stream", header)
            elif self.path == "/reset":
                backend.reset()
                self._send(200, b"{}", "application/json")
            else:
                self._send(404, b"not found", "text/plain")

    return Handler


def serve(simulation, port: int = 8787, host: str = "127.0.0.1"):
    """Start the viewer server (blocking); returns the server object when
    started with ``block=False`` via :func:`start_in_thread`."""
    backend = ViewerBackend(simulation)
    server = ThreadingHTTPServer((host, port), _make_handler(backend))
    return server, backend


def start_in_thread(simulation, port: int = 8787):
    """Non-blocking server start (used by tests and notebooks); port 0
    takes a free one (``server.server_address[1]``)."""
    server, backend = serve(simulation, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, backend, thread


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m civiwave_tpu_torch.ui.viewer",
        description="Interactive WebGL viewer for a CiviWave scenario.",
    )
    parser.add_argument("scenario", help="path to the scenario YAML")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the simulation runs on (default cuda; cpu runs "
        "the plain PyTorch versions of the kernels)",
    )
    args = parser.parse_args(argv)

    from ..runner import build_simulation

    try:
        sim = build_simulation(args.scenario, device=args.device)
        server, backend = serve(sim, args.port, args.host)
    except CwfError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(
        f"viewer: {backend.node_count:,} nodes / "
        f"{backend.element_count:,} elements at "
        f"http://{args.host}:{args.port}/ (Ctrl+C to stop)"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
