"""``python -m civiwave_tpu_torch.parallel.launch`` on the general path and
with ``--static``, over spawned gloo ranks, through its own
``--against-one-rank`` check (iterations within 1 for frames, u within
2.5e-4 and a within 3e-3 of the one-rank run's max; a static solve: both
converged and u within 2.5e-4):

* ``examples/seismic_column_tet.yaml`` (a Gmsh tet column, two materials,
  a curve load) over 2 ranks: the halo operator, 'auto' = fused;
* the tet cantilever box over 2 ranks with ``CIVIWAVE_GENERAL_HALO=0``:
  the all-gather form, counted, no ghost exchange; with ``--profile``,
  every rank of both runs writes a trace and each run's rank 0 prints
  its summary;
* a static solve of the tet cantilever box over 2 ranks.

Each run is killed if it outlasts ``JOIN_TIMEOUT``.
"""

import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 120  # seconds for one launcher run (group and one rank)

CASES = {
    "column_2": (["--npx", "2", "--scenario",
                  os.path.join(REPO, "examples", "seismic_column_tet.yaml"),
                  "--frames", "3"], {}),
    "gathered_2": (["--npx", "2", "--cells", "16,3,3,tet", "--frames", "2"],
                   {"CIVIWAVE_GENERAL_HALO": "0"}),
    "static_2": (["--npx", "2", "--cells", "12,3,3,tet", "--static"], {}),
}


def _launch(args, env_extra, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env_extra)
    cmd = [sys.executable, "-m", "civiwave_tpu_torch.parallel.launch", *args,
           "--device", "cpu", "--init-method", f"file://{tmp_path / 'store'}",
           "--timeout", str(JOIN_TIMEOUT // 2 - 5), "--against-one-rank"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"launcher still running after {JOIN_TIMEOUT} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_launcher_general_path_against_one_rank(name, tmp_path):
    args, env = CASES[name]
    traces = tmp_path / "traces"
    if name == "gathered_2":
        args = [*args, "--profile", str(traces)]
    rc, log = _launch(args, env, tmp_path)
    assert rc == 0, log
    if name == "gathered_2":  # the group's 2 ranks and the one rank
        assert len(list(traces.glob("civiwave_*.trace.json"))) == 3
        summaries = [ln for ln in log.splitlines()
                     if ln.startswith("profile summary: ")]
        assert len(summaries) == 2 and all("ms wall" in ln for ln in summaries), log
    [line] = [ln for ln in log.splitlines() if ln.startswith("against one rank")]
    assert "FAIL" not in line, line
    exchanges = int(line.split("ghost exchanges ")[1].split(",")[0])
    gathers = int(line.split("all-gathers ")[1].split(";")[0])
    iters = [int(k) for k in
             line.split("iterations [")[1].split("]")[0].split(",")]
    if name == "gathered_2":
        # classic over the all-gather form: no exchange, one gather per
        # matvec (the Rayleigh and residual matvecs per frame, then one
        # per iteration)
        assert exchanges == 0 and gathers == 2 * len(iters) + sum(iters), line
        assert "PCG classic" in line, line
    else:
        assert exchanges > 0 and gathers == 0, line
        assert "PCG fused" in line, line
