"""The harness: cells resolve to their files, the traffic follows the seed,
the curves are long enough, and BENCHMARK.json and the result line keep to
the benchmark's contract.  CPU only (the runs are the cells' small sizes).

    python -m pytest -q benchmarks/tests
"""

from __future__ import annotations

import json
import re

import numpy as np
import pytest
import torch

from benchmarks.harness.cells import BENCH_DIR, ROOT, load_benchmark, metric_reader, resolve
from benchmarks.harness.traffic import generate
from benchmarks.harness.work import assemble_tet, tet_element_forces
from benchmarks.reference.mesh import parse_box
from benchmarks.tests.support import CELLS, OUTPUT_CELL, run_small, small_cell, small_mesh

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = resolve(cell)
    assert c.config["name"] == c.config_name
    assert c.config["scenario"]["mesh"]["path"].startswith("synthetic://box/")
    assert {"residual", "u_update", "v_update"} <= set(c.limits)
    assert int(c.limits["frames_checked"]) >= 1
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("mix", ["sway", "probes", "impact"])
def test_zero_crossings_are_zero(mix):
    """A first frame from rest under a load of 1e-16 of its scale makes the
    program's PCG report a breakdown: zero crossings are sampled as 0."""
    spec = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    for seed in range(40):
        v = np.abs(np.array(generate(spec, seed).curve)[:, 1])
        assert not ((v > 0) & (v < 1e-9)).any()


@pytest.mark.parametrize("mix", ["sway", "probes", "impact"])
def test_traffic_follows_the_seed(mix):
    spec = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    a, b = generate(spec, 2**31 + 7), generate(spec, 2**31 + 7)
    c = generate(spec, 12345)
    assert a.curve == b.curve
    assert a.curve != c.curve
    # the same set of amplitude factors, in another order
    va, vc = np.array(a.curve)[:, 1], np.array(c.curve)[:, 1]
    assert np.isclose(np.abs(va).max(), np.abs(vc).max(), rtol=0.02)
    assert generate(spec, -5).curve  # any whole number is a seed


@pytest.mark.parametrize("mix", ["sway", "probes", "impact"])
def test_curve_covers_ten_windows(mix):
    spec = json.loads((BENCH_DIR / "traffic" / f"{mix}.json").read_text())
    window = BENCH["run_seconds"] * spec["sized_for_steps_per_s"]
    warm = spec["warmup_frames"] + spec.get("output_warmup_frames", 0)
    assert spec["frames"] >= warm + 10 * window
    t = generate(spec, 1)
    assert len(t.curve) == spec["frames"] + 1
    assert t.curve[-1][0] == pytest.approx(spec["frames"] * spec["dt"])


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for c in m.get("workloads", []):
            assert c in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        # each cell that reads the metric reports the end-to-end one it moves
        for c in m.get("workloads", CELLS):
            assert m["moves"] in {e["name"] for e in resolve(c).end_to_end}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmarks/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


def _check_line(result, metrics):
    assert list(result)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    json.loads(json.dumps(result))
    assert set(result["metrics"]) <= metrics
    for name, m in result["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert isinstance(m["value"], float)
    for name, entry in result["check"].items():
        assert set(entry) == {"value", "limit"}


def test_work_counts_of_the_kernel_table():
    """K7 and G1 at 66^3 tet: the least bytes of PERF.md's kernel table."""
    box = parse_box("synthetic://box/66,66,66,tet")
    assert tet_element_forces(box) == (218_408_469, 171 * 1_724_976)
    assert assemble_tet(box)[0] == 147_321_733


@pytest.mark.parametrize("cell", CELLS + [OUTPUT_CELL])
def test_result_line_schema(cell):
    """Every end-to-end metric of the cell in a plain run but those read
    from the device's trace, which find nothing to read on the CPU; the
    per-layer ones that find something to read there in a traced run."""
    c = small_cell(cell)
    result = run_small(cell, 99)
    assert result["correct"], result["check"]
    _check_line(result, {m["name"] for m in c.end_to_end})
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end
                                      if m["source"] == "host_clock"}
    traced = run_small(cell, 99, trace=True)
    _check_line(traced, {m["name"] for m in c.per_layer})
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the device metrics find nothing to read and are left out
    assert "device_idle_share" not in traced["metrics"]
    assert traced["metrics"]["build_s"]["value"] > 0
    for name in ("pcg_iters_per_step", "pcg_iters_per_step.general"):
        if name in {m["name"] for m in c.per_layer}:
            assert traced["metrics"][name]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import io
    import time

    from benchmarks.run import run_cell

    c = small_cell(cell)
    result = run_cell(c, 7, 0.5, True, torch.device("cuda", 0), time.monotonic(),
                      mesh_path=small_mesh(c.config), log=io.StringIO())
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
