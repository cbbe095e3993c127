"""The port's web viewer (``civiwave_tpu_torch/ui/viewer.py`` and its page):
the cases of ``tests/test_viewer.py`` and ``tests/test_viewer_math.py``
against the port, on the CPU.

* the page is the JAX package's ``viewer.html`` byte for byte;
* the HTTP round trip on a served 6x3x3 box: the page, the mesh blob, a
  solve with a point load (a second, unloaded solve does not keep the
  load), reset, and the overlay payload;
* the camera and picking math: the JS lines the numpy mirrors of
  ``tests/test_viewer_math.py`` follow are in the port's page verbatim,
  its mirrored function bodies equal the golden copy, and the mirrors'
  invariants hold (the mirrors are imported from that file);
* ``main`` takes ``--device`` (default cuda) and builds the scenario there.
"""

import dataclasses
import json
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.ui import viewer

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))

import test_viewer_math as mirror  # noqa: E402

torch.set_num_threads(2)

PAGE = REPO / "civiwave_tpu_torch" / "ui" / "viewer.html"
_HTML = PAGE.read_text()
_YAML = """
mesh: {path: "synthetic://box/6,3,3"}
materials:
  - {name: steel, E: 2.0e11, nu: 0.3, rho: 7800.0}
assignments: [{group: SOLID, material: steel}]
damping: {xi: 0.02, w1: 10.0, w2: 100.0}
time: {dt: 0.002, adaptive: false, min_dt: 0.001, max_dt: 0.004}
solver: {type: pcg, preconditioner: block_jacobi, tol_runtime: 1.0e-6,
         tol_pause: 1.0e-8, max_iters: 300}
precision: {vectors: fp32, reductions: fp64}
loads:
  gravity: [0.0, 0.0, -9.81]
  tractions: [{group: LOAD_FACE, value: [0.0, 0.0, -2.0e5]}]
dirichlet: {fixes: [{group: FIXED, dof: [x, y, z]}]}
output: {vtu_stride: 1, probes: []}
"""


def test_page_is_the_reference_page():
    reference = REPO / "civiwave_tpu" / "ui" / "viewer.html"
    assert PAGE.read_bytes() == reference.read_bytes()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    path = tmp_path_factory.mktemp("viewer") / "box.yaml"
    path.write_text(_YAML)
    return str(path)


@pytest.fixture(scope="module")
def served(scenario):
    from civiwave_tpu_torch.runner import build_simulation

    sim = build_simulation(scenario, device="cpu")
    server, backend, thread = viewer.start_in_thread(sim, port=0)
    port = server.server_address[1]
    yield f"http://127.0.0.1:{port}", backend
    server.shutdown()
    server.server_close()


def _post(url, body: bytes = b""):
    return urllib.request.urlopen(
        urllib.request.Request(url, data=body, method="POST"))


def test_viewer_page_and_mesh(served):
    base, backend = served
    page = urllib.request.urlopen(base + "/").read()
    assert page == PAGE.read_bytes()
    assert b"webgl2" in page and b"von Mises" in page

    r = urllib.request.urlopen(base + "/mesh")
    hdr = json.loads(r.headers["X-Civiwave"])
    blob = r.read()
    n, f = hdr["nodes"], hdr["tris"]
    assert n == backend.node_count and hdr["structured"]
    assert len(blob) == n * 12 + f * 12
    tris = np.frombuffer(blob, np.int32, f * 3, offset=n * 12)
    assert tris.min() >= 0 and tris.max() < n


def test_viewer_solve_roundtrip_and_reset(served):
    base, backend = served
    n = backend.node_count
    r = _post(base + "/solve", json.dumps(
        {"enabled": True, "anchor": n - 1, "direction": [0, 0, -1],
         "magnitude": 1.0e4}).encode())
    tele = json.loads(r.headers["X-Civiwave"])
    blob = r.read()
    assert tele["converged"] and tele["iterations"] > 0
    assert len(blob) == n * 12 + n * 4
    u = np.frombuffer(blob, np.float32, n * 3).reshape(n, 3)
    vm = np.frombuffer(blob, np.float32, n, offset=n * 12)
    assert np.isfinite(u).all() and np.abs(u).max() > 0.0
    assert vm.max() > 0.0

    # each solve restores the baseline first (SimulationBackend parity):
    # a zero-load solve after a loaded one must not accumulate the load
    r2 = _post(base + "/solve", b'{"enabled": false}')
    u2 = np.frombuffer(r2.read(), np.float32, n * 3).reshape(n, 3)
    assert np.abs(u2).max() < np.abs(u).max()

    assert _post(base + "/reset").read() == b"{}"
    np.testing.assert_array_equal(backend.sim.stepper.displacement(), 0.0)


def test_viewer_overlay_payload(served):
    """Directional display-stress overlay (viewer.cpp:2940-2999): a third
    (N,) f32 array, an auto-derived falloff in the header, the anchor
    boosted and no vertex lowered."""
    base, backend = served
    n = backend.node_count
    anchor = n - 1
    r = _post(base + "/solve", json.dumps(
        {"enabled": True, "anchor": anchor, "direction": [-1, 0, 0],
         "magnitude": 1.0e4, "overlay": True}).encode())
    tele = json.loads(r.headers["X-Civiwave"])
    blob = r.read()
    assert tele["overlay"] is True
    assert 0.05 <= tele["falloff"] <= 2.0
    assert len(blob) == n * 12 + n * 4 + n * 4
    vm = np.frombuffer(blob, np.float32, n, offset=n * 12)
    display = np.frombuffer(blob, np.float32, n, offset=n * 16)
    assert np.isfinite(display).all()
    boost = display - vm
    assert boost[anchor] > 0.0
    assert boost.min() >= -1e-4 * max(1.0, float(vm.max()))
    assert tele["overlay_max"] >= tele["vm_max"]


def test_viewer_page_has_overlay_controls(served):
    base, _ = served
    page = urllib.request.urlopen(base + "/").read()
    assert b"stress overlay" in page and b"depth test" in page
    assert b"falloff" in page


def test_main_takes_the_device(scenario, monkeypatch, capsys):
    """``main --device cpu`` builds the scenario on the CPU and serves it
    (the server's loop stubbed to return at once)."""
    from civiwave_tpu_torch import runner

    seen = {}
    build = runner.build_simulation

    def spy(path, device="cuda", **kw):
        seen["device"] = device
        return build(path, device=device, **kw)

    monkeypatch.setattr(runner, "build_simulation", spy)
    monkeypatch.setattr(viewer.ThreadingHTTPServer, "serve_forever",
                        lambda self: self.server_close())
    assert viewer.main([scenario, "--device", "cpu", "--port", "0"]) == 0
    assert seen["device"] == "cpu"
    assert "viewer: 112 nodes" in capsys.readouterr().out


# --- the camera and picking math of the port's page -------------------------


def test_pinned_js_formulas_present():
    for line in mirror._PINNED_JS:
        assert line in _HTML, f"viewer.html no longer contains: {line!r}"


def test_math_function_bodies_match_golden(monkeypatch):
    monkeypatch.setattr(mirror, "_HTML", _HTML)
    golden = (REPO / "tests" / "data" / "viewer_math_golden.js").read_text()
    extracted = "\n\n".join(
        mirror._extract_js_function(n) for n in mirror._MIRRORED_FUNCS) + "\n"
    assert extracted == golden


@pytest.mark.parametrize("case", [
    "test_camera_center_projects_to_screen_origin",
    "test_camera_depth_ordering_and_clip",
    "test_pick_roundtrip_recovers_vertex",
    "test_pick_ignores_vertices_behind_eye",
    "test_direction_unit_vector_and_poles",
    "test_orbit_and_zoom_increments_behave",
    "test_perspective_matrix_invariants",
    "test_mat_mul_matches_numpy_column_major",
])
def test_mirror_invariants(case):
    """The invariants of the mirrors that the pinned lines tie to the
    port's page."""
    getattr(mirror, case)()


def test_viewer_serves_a_general_path_scenario():
    """A Gmsh scenario (tets, the general path): its surface mesh and a
    solve round trip."""
    from civiwave_tpu_torch.config.loader import load_config_from_file
    from civiwave_tpu_torch.runner import build_simulation

    cfg = load_config_from_file(str(REPO / "tests" / "data" / "cantilever.yaml"))
    cfg = dataclasses.replace(cfg, mesh_path=str(REPO / cfg.mesh_path))
    server, backend, _ = viewer.start_in_thread(
        build_simulation(cfg, device="cpu"), port=0)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        hdr = json.loads(urllib.request.urlopen(base + "/mesh")
                         .headers["X-Civiwave"])
        assert not hdr["structured"] and hdr["nodes"] == backend.node_count
        r = _post(base + "/solve", json.dumps(
            {"enabled": True, "anchor": 3, "magnitude": 1e4}).encode())
        assert json.loads(r.headers["X-Civiwave"])["converged"]
        assert len(r.read()) == backend.node_count * 16
    finally:
        server.shutdown()
        server.server_close()
