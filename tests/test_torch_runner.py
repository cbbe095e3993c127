"""The whole structured slice of the port against the JAX reference runner.

``examples/cantilever_box.yaml`` (24x8x8 hex cantilever: gravity, a
curve-ramped traction, adaptive dt) runs 10 frames through both runners.
Tolerances (the BASELINE stepping tolerances in ROADMAP): PCG iterations
within +-1 per frame (equality expected), an identical dt sequence,
displacement at 2.5e-4 * max|ref| and acceleration at 3e-3 * max|ref|.
A second port run takes the reference's model and state over through
``convert`` after frame 5 and continues.  The CLI runs 3 frames.
"""

import json
import os

import numpy as np
import pytest
import torch

from civiwave_tpu.runner import build_simulation as jbuild_simulation
from civiwave_tpu_torch import convert
from civiwave_tpu_torch.runner import build_simulation, main

from test_torch_structured import to_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = os.path.join(REPO, "examples", "cantilever_box.yaml")
U_TOL, A_TOL = 2.5e-4, 3e-3


@pytest.fixture(scope="module")
def reference_run():
    """The reference's 10 frames, with its model and state after frame 5."""
    sim = jbuild_simulation(SCENARIO)
    first = sim.run(5)
    stepper = sim.stepper
    handover = dict(
        state=[np.asarray(v) for v in (
            stepper.state.displacement, stepper.state.velocity,
            stepper.state.acceleration, stepper.state.warm_x,
        )],
        dt=stepper.current_dt,
        time=stepper.accumulated_time,
        frame=stepper.frame_index,
        model=to_port(sim.model),
    )
    second = sim.run(5)
    final = {
        "displacement": np.asarray(stepper.state.displacement),
        "acceleration": np.asarray(stepper.state.acceleration),
    }
    return first + second, handover, final


def _compare(telemetries, ref_telemetries, state, final):
    iters = [t.pcg_iterations for t in telemetries]
    ref_iters = [t.pcg_iterations for t in ref_telemetries]
    assert all(abs(a - b) <= 1 for a, b in zip(iters, ref_iters)), (iters, ref_iters)
    assert [t.time_step for t in telemetries] == [
        t.time_step for t in ref_telemetries
    ]
    assert [t.simulation_time for t in telemetries] == pytest.approx(
        [t.simulation_time for t in ref_telemetries], rel=1e-12
    )
    assert all(t.pcg_converged for t in telemetries)
    for name, tol in (("displacement", U_TOL), ("acceleration", A_TOL)):
        ref = final[name]
        np.testing.assert_allclose(
            getattr(state, name).numpy(), ref, rtol=0.0,
            atol=tol * np.abs(ref).max(), err_msg=name,
        )


def test_ten_frames_match_reference(reference_run):
    ref_tel, _, final = reference_run
    sim = build_simulation(SCENARIO, device="cpu")
    tel = sim.run(10)
    _compare(tel, ref_tel, sim.stepper.state, final)
    assert sim.stepper.frame_index == 10


def test_handover_mid_run_through_convert(reference_run):
    ref_tel, handover, final = reference_run
    sim = build_simulation(SCENARIO, device="cpu")
    sim.model = sim.stepper.model = handover["model"]
    sim.stepper.state = convert.sim_state_from_arrays(*handover["state"], "cpu")
    sim.stepper.current_dt = handover["dt"]
    sim.stepper.accumulated_time = handover["time"]
    sim.stepper.frame_index = handover["frame"]
    tel = sim.run(5)
    _compare(tel, ref_tel[5:], sim.stepper.state, final)


def test_cli_runs_and_writes_telemetry(tmp_path, capsys):
    out = tmp_path / "telemetry.json"
    rc = main([SCENARIO, "--frames", "3", "--quiet", "--device", "cpu",
               "--telemetry-json", str(out)])
    assert rc == 0
    frames = json.loads(out.read_text())
    assert len(frames) == 3 and all(f["pcg_converged"] for f in frames)
    assert "ran 3 frames" in capsys.readouterr().out


def test_cli_runs_the_tet_basin_on_the_general_path(capsys, tmp_path):
    """examples/seismic_basin.yaml meshed with tets takes the general path,
    whose absorbing faces are ported: exit code 0, every frame converged."""
    with open(os.path.join(REPO, "examples", "seismic_basin.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    assert "synthetic://box/48,48,24" in text
    path = tmp_path / "basin_tet.yaml"
    path.write_text(text.replace("synthetic://box/48,48,24",
                                 "synthetic://box/3,3,2,tet"))
    out = tmp_path / "telemetry.json"
    rc = main([str(path), "--frames", "3", "--device", "cpu", "--quiet",
               "--telemetry-json", str(out)])
    assert rc == 0
    frames = json.loads(out.read_text())
    assert len(frames) == 3 and all(f["pcg_converged"] for f in frames)
    assert "general gather path" in capsys.readouterr().err


def test_cli_runs_seismic_basin_on_the_structured_route(capsys, tmp_path):
    """examples/seismic_basin.yaml (five absorbing faces, curve traction on
    the free top) runs through the CLI, reduced to a 6x6x3 box."""
    with open(os.path.join(REPO, "examples", "seismic_basin.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    path = tmp_path / "basin.yaml"
    path.write_text(text.replace("synthetic://box/48,48,24",
                                 "synthetic://box/6,6,3"))
    out = tmp_path / "telemetry.json"
    rc = main([str(path), "--frames", "3", "--device", "cpu", "--quiet",
               "--telemetry-json", str(out)])
    assert rc == 0
    frames = json.loads(out.read_text())
    assert len(frames) == 3 and all(f["pcg_converged"] for f in frames)
    assert "structured route" in capsys.readouterr().err
