"""Output of the port (``civiwave_tpu_torch/post``) against the JAX reference.

* ``compute_derived_fields`` (host numpy) on one seeded displacement:
  equal to the reference's to f32 rounding, tet and hex;
* ``compute_structured_derived`` (torch, CPU tensors) against the
  reference's jitted function at 1e-6 of max|.| per field, and through
  ``derived_to_host`` against the host path over the same box; with dead
  +Y rows (``pad_rows``) the port strips them as ``to_nodal`` does, where
  the reference interleaves them (a fault of the reference, checked here);
* ``probe_samples`` / ``probe_derived_host`` against the node fields and
  against the reference's, and out-of-range probes;
* ``write_vtu`` and ``write_vtu_structured`` byte-identical to the
  reference's writers on the same arrays, numpy writer and native writer
  (the native case skips where g++ is missing), and the Int32 guard;
* ``ProbeLogger`` CSV text identical; ``OutputManager`` stride;
  ``AsyncWriter`` raises a worker's exception; a one-rank group's
  ``StructuredOutputManager`` writes the unsharded manager's files;
  ``save_snapshot`` writes a PNG;
* ``examples/cantilever_box.yaml --output`` for 5 frames: the same file set
  as the reference runner and its probe CSV within the BASELINE
  tolerances.

Inputs come from seeded numpy and reach both packages as the same arrays.
"""

import csv
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from civiwave_tpu.mesh import preprocess as jpreprocess
from civiwave_tpu.mesh import structured as jstructured
from civiwave_tpu.physics import materials as jmaterials
from civiwave_tpu.post import derived as jderived
from civiwave_tpu.post import native_vtu as jnative_vtu
from civiwave_tpu.post import probes as jprobes
from civiwave_tpu.post import structured_fields as jfields
from civiwave_tpu.post import vtu as jvtu
from civiwave_tpu.runner import main as jmain
from civiwave_tpu.utils import synthetic as jsynthetic
from civiwave_tpu_torch.mesh import preprocess
from civiwave_tpu_torch.mesh import structured as tstructured
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.post import derived, native_vtu, output, probes
from civiwave_tpu_torch.post import structured_fields as fields
from civiwave_tpu_torch.post import vtu
from civiwave_tpu_torch.runner import main
from civiwave_tpu_torch.utils import synthetic
from civiwave_tpu_torch.utils.errors import ProbeError, VtuError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_YAML = os.path.join(REPO, "examples", "cantilever_box.yaml")
U_TOL, A_TOL = 2.5e-4, 3e-3
NAMES = ("element_strain", "element_stress", "element_von_mises",
         "node_strain", "node_stress", "node_von_mises")
GRIDS = {
    "plain": ((5, 3, 4), {}),
    "xpad": ((4, 3, 3), dict(pad_x_multiple=4)),
    "spacing": ((3, 4, 2), dict(spacing=(0.3, 0.7, 1.1))),
}


def host_pair(nx, ny, nz, hex_elements):
    """(mesh, preprocess, D tables) of one box in each package."""
    out = []
    for syn, pre_mod, mat_mod in ((synthetic, preprocess, materials),
                                  (jsynthetic, jpreprocess, jmaterials)):
        cfg = syn.cantilever_config()
        mesh = syn.box_mesh(nx, ny, nz, hex_elements=hex_elements)
        _, _, d_all = mat_mod.material_tables(
            [mat_mod.make_properties(m) for m in cfg.materials])
        out.append((mesh, pre_mod.run(mesh, cfg), d_all))
    return out


def structured_pair(dims, kw):
    mat = synthetic.cantilever_config().materials[0]
    tm, _ = tstructured.build_structured_model(
        *dims, materials.make_properties(mat), mat.density, device="cpu", **kw)
    jm, _ = jstructured.build_structured_model(
        *dims, jmaterials.make_properties(mat), mat.density, **kw)
    return tm, jm


def random_csg(model, seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((model.node_count, 3)) * scale).astype(np.float32)
    return rows, model.from_nodal(rows)


def random_derived(rng, n_nodes, n_cells):
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (n_cells, 6), (n_cells, 6), (n_cells,),
        (n_nodes, 6), (n_nodes, 6), (n_nodes,))]


@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_compute_derived_fields_matches_reference(hex_elements):
    (tmesh, tpre, td), (jmesh, jpre, jd) = host_pair(4, 3, 2, hex_elements)
    rng = np.random.default_rng(1)
    u = (rng.standard_normal((tmesh.node_count, 3)) * 1e-3).astype(np.float32)
    got = derived.compute_derived_fields(
        tpre, td, u, tmesh.node_count, tmesh.element_count)
    ref = jderived.compute_derived_fields(
        jpre, jd, u, jmesh.node_count, jmesh.element_count)
    for name in NAMES:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(
        derived.von_mises(got.node_stress.astype(np.float64)),
        jderived.von_mises(got.node_stress.astype(np.float64)))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_compute_structured_derived_matches_reference(grid):
    tm, jm = structured_pair(*GRIDS[grid])
    _, u = random_csg(tm, seed=2)
    got = fields.compute_structured_derived(tm, u)
    ref = jfields.compute_structured_derived(jm, jnp.asarray(u.numpy()))
    for name, a, b in zip(NAMES, got, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0.0,
                                   atol=1e-6 * np.abs(b).max(), err_msg=name)


def test_structured_derived_matches_host_path():
    """The uniform-grid collapse equals the host per-quadrature-row path
    over the same box (the reference's own check, on the port)."""
    nx, ny, nz = 5, 3, 4
    tm, _ = structured_pair((nx, ny, nz), {})
    rows, u = random_csg(tm, seed=3, scale=1.0)
    fast = fields.derived_to_host(tm, fields.compute_structured_derived(tm, u))
    (mesh, pre, d_all), _ = host_pair(nx, ny, nz, True)
    ref = derived.compute_derived_fields(
        pre, d_all, rows, mesh.node_count, mesh.element_count)
    for name in NAMES:
        a, b = getattr(fast, name), getattr(ref, name)
        np.testing.assert_allclose(a, b, atol=5e-6 * np.abs(b).max(), err_msg=name)


def test_derived_to_host_strips_dead_rows():
    """With dead +Y rows the port's host rows equal those of the unpadded
    grid (dead rows stripped first, as to_nodal); the reference keeps the
    first N rows of the padded x-major order, so its node rows interleave
    dead rows (ROADMAP §C, a fault of the reference)."""
    dims = (4, 2, 3)
    plain_t, plain_j = structured_pair(dims, {})
    pad_t, pad_j = structured_pair(dims, dict(pad_y_multiple=2))
    assert pad_t.pad_rows == pad_j.pad_rows == 1
    rows, u_plain = random_csg(plain_t, seed=4)
    u_pad = pad_t.from_nodal(rows)
    want = fields.derived_to_host(
        plain_t, fields.compute_structured_derived(plain_t, u_plain))
    got = fields.derived_to_host(
        pad_t, fields.compute_structured_derived(pad_t, u_pad))
    for name in NAMES:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=1e-12, err_msg=name)
    ref = jfields.derived_to_host(pad_j, jfields.compute_structured_derived(
        pad_j, jnp.asarray(u_pad.numpy())))
    assert np.abs(ref.node_von_mises - want.node_von_mises).max() > 1e3 * (
        np.abs(want.node_von_mises).max() * 1e-6)


PROBES = (0, 7, 33, 59, 119)  # corner, edges, interior, far corner of 5x3x4


def test_probe_samples_match_node_fields():
    tm, _ = structured_pair((5, 3, 4), {})
    _, u = random_csg(tm, seed=5)
    rng = np.random.default_rng(6)
    v, a = (torch.from_numpy(rng.standard_normal(tm.vector_shape).astype(np.float32))
            for _ in range(2))
    state = tm.zero_state().__class__(u, v, a, u)
    kin, windows = fields.probe_samples(tm, state, PROBES)
    assert kin.shape == (len(PROBES), 3, 3) and kin.dtype == np.float32
    for row, t in enumerate((u, v, a)):
        np.testing.assert_array_equal(kin[:, row], tm.to_nodal(t).numpy()[list(PROBES)])
    host = fields.derived_to_host(tm, fields.compute_structured_derived(tm, u))
    smax = np.abs(host.node_stress).max()
    for p, (strain, stress, vm) in zip(
            PROBES, fields.probe_derived_host(tm, PROBES, windows)):
        np.testing.assert_allclose(stress, host.node_stress[p], atol=1e-5 * smax)
        np.testing.assert_allclose(strain, host.node_strain[p],
                                   atol=1e-5 * np.abs(host.node_strain).max())
        assert abs(vm - host.node_von_mises[p]) <= 1e-5 * smax


def test_probe_samples_match_reference():
    tm, jm = structured_pair((5, 3, 4), {})
    _, u = random_csg(tm, seed=7)
    state = tm.zero_state().__class__(u, u * 2, u * 3, u)
    kin, windows = fields.probe_samples(tm, state, PROBES)
    jstate = jm.zero_state().__class__(*(
        jnp.asarray(t.numpy()) for t in (u, u * 2, u * 3, u)))
    jkin, jwindows = jfields.probe_samples(jm, jstate, PROBES)
    np.testing.assert_array_equal(kin, np.asarray(jkin))
    for w, jw in zip(windows, jwindows):
        np.testing.assert_array_equal(w, np.asarray(jw))
    for got, ref in zip(fields.probe_derived_host(tm, PROBES, windows),
                        jfields.probe_derived_host(jm, PROBES, jwindows)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


def test_probe_out_of_range_raises():
    tm, _ = structured_pair((2, 2, 2), {})
    with pytest.raises(ProbeError):
        fields.probe_samples(tm, tm.zero_state(), (0, tm.node_count))


def _writers(monkeypatch, native):
    """Pick the writer in both packages: native (skip without g++) or the
    numpy path."""
    if native:
        if shutil.which("g++") is None or not native_vtu.available():
            pytest.skip("no native toolchain")
        assert jnative_vtu.available()
    else:
        monkeypatch.setattr(native_vtu, "available", lambda: False)
        monkeypatch.setattr(jnative_vtu, "available", lambda: False)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("hex_elements", [False, True], ids=["tet", "hex"])
def test_write_vtu_byte_identical(hex_elements, native, tmp_path, monkeypatch):
    _writers(monkeypatch, native)
    (tmesh, _, _), (jmesh, _, _) = host_pair(3, 2, 2, hex_elements)
    n, e = tmesh.node_count, tmesh.element_count
    rng = np.random.default_rng(8)
    u, v, a = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    arrays = random_derived(rng, n, e)
    vtu.write_vtu(str(tmp_path / "p.vtu"), tmesh, u, v, a,
                  derived.DerivedFieldSet(*arrays), 0.25, 4)
    jvtu.write_vtu(str(tmp_path / "j.vtu"), jmesh, u, v, a,
                   jderived.DerivedFieldSet(*arrays), 0.25, 4)
    assert (tmp_path / "p.vtu").read_bytes() == (tmp_path / "j.vtu").read_bytes()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_write_vtu_structured_byte_identical(native, tmp_path, monkeypatch):
    """The implicit-connectivity writer equals the reference's, and equals
    the explicit writer over the same box."""
    _writers(monkeypatch, native)
    nx, ny, nz = 3, 2, 4
    (mesh, _, _), _ = host_pair(nx, ny, nz, True)
    n, e = mesh.node_count, mesh.element_count
    rng = np.random.default_rng(9)
    u, v, a = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    arrays = random_derived(rng, n, e)
    points = (mesh.node_positions.astype(np.float32) + u).astype(np.float32)
    vtu.write_vtu_structured(str(tmp_path / "p.vtu"), nx, ny, nz, points, u, v,
                             a, derived.DerivedFieldSet(*arrays), 0.5, 3)
    jvtu.write_vtu_structured(str(tmp_path / "j.vtu"), nx, ny, nz, points, u, v,
                              a, jderived.DerivedFieldSet(*arrays), 0.5, 3)
    vtu.write_vtu(str(tmp_path / "x.vtu"), mesh, u, v, a,
                  derived.DerivedFieldSet(*arrays), 0.5, 3)
    blob = (tmp_path / "p.vtu").read_bytes()
    assert blob == (tmp_path / "j.vtu").read_bytes()
    assert blob == (tmp_path / "x.vtu").read_bytes()


def test_write_vtu_structured_int32_guard(tmp_path):
    z3, z1 = np.zeros((8, 3), np.float32), np.zeros(8, np.float32)
    fs = derived.DerivedFieldSet(z3, z3, z1, z3, z3, z1)
    with pytest.raises(VtuError):
        vtu.write_vtu_structured(str(tmp_path / "huge.vtu"), 700, 700, 700,
                                 z3, z3, z3, z3, fs, 0.0, 0)
    assert not (tmp_path / "huge.vtu").exists()


def test_probe_logger_csv_identical(tmp_path):
    rng = np.random.default_rng(10)
    n = 6
    u, v, a = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(3))
    arrays = random_derived(rng, n, 4)
    kin = rng.standard_normal((2, 3, 3)).astype(np.float32)
    rows = [(rng.standard_normal(6).astype(np.float32),
             rng.standard_normal(6).astype(np.float32), float(rng.random()))
            for _ in range(2)]
    texts = []
    for mod, dmod, name in ((probes, derived, "p.csv"), (jprobes, jderived, "j.csv")):
        logger = mod.ProbeLogger(str(tmp_path / "d" / name), [1, 4])
        logger.log_frame(0.125, 3, u, v, a, dmod.DerivedFieldSet(*arrays))
        logger.log_sampled(0.25, 4, n, kin, rows)
        texts.append((tmp_path / "d" / name).read_text())
    assert texts[0] == texts[1]
    assert texts[0].count("\n") == 5
    with pytest.raises(ProbeError):
        probes.ProbeLogger(str(tmp_path / "e.csv"), [n]).log_frame(
            0.0, 0, u, v, a, derived.DerivedFieldSet(*arrays))


def test_output_manager_stride(tmp_path):
    (mesh, pre, d_all), _ = host_pair(2, 2, 2, False)
    cfg = synthetic.cantilever_config(output={"vtu_stride": 2, "probes": [0, 3]})
    manager = output.OutputManager(str(tmp_path), cfg.output, mesh, pre, d_all)
    z = np.zeros((mesh.node_count, 3), np.float32)
    for frame in range(5):
        manager.handle_frame(0.01 * frame, frame, z, z, z)
    manager.flush()
    assert sorted(os.listdir(tmp_path / "vtu")) == [
        "frame_00000.vtu", "frame_00002.vtu", "frame_00004.vtu"]
    with open(tmp_path / "probes" / "probes.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 5 * 2


def test_async_writer_raises_a_worker_error():
    writer = output.AsyncWriter()

    def boom():
        raise VtuError("disk full", ["x.vtu"])

    writer.submit(boom)
    with pytest.raises(VtuError, match="disk full"):
        writer.flush()
    writer.submit(lambda: None)
    writer.flush()


def test_structured_output_manager_on_a_one_rank_group(tmp_path):
    """A one-rank group's manager (a shard: the derived fields from the
    exchanged block, the probes through one gather) writes, for the same
    states, byte for byte the files of the unsharded manager; dead +X
    planes and a dead +Y row are stripped from both."""
    from civiwave_tpu_torch.parallel import sharding

    tm, _ = structured_pair((5, 3, 4), dict(pad_x_multiple=4, pad_y_multiple=3))
    cfg = synthetic.cantilever_config(
        output={"vtu_stride": 2, "probes": list(PROBES)})
    rng = np.random.default_rng(8)
    states = [tm.zero_state().__class__(*(torch.from_numpy(
        rng.standard_normal(tm.vector_shape).astype(np.float32) * 1e-3)
        for _ in range(4))) for _ in range(3)]
    group = sharding.make_shard_group_2d(1, 1, "cpu")
    try:
        shard, _, _ = sharding.shard_structured(tm, tm.zero_state(),
                                                tm.zero_state().displacement,
                                                group)
        for model, root in ((tm, tmp_path / "plain"), (shard, tmp_path / "shard")):
            manager = output.StructuredOutputManager(str(root), cfg.output, model)
            for frame, state in enumerate(states):
                stepper = type("Stepper", (), {"model": model, "state": state})
                manager.handle_from_stepper(0.01 * frame, frame, stepper)
            manager.flush()
    finally:
        sharding.close_shard_group()
    files = ["probes/probes.csv", "vtu/frame_00000.vtu", "vtu/frame_00002.vtu"]
    for f in files:
        assert (tmp_path / "shard" / f).read_bytes() == (
            tmp_path / "plain" / f).read_bytes(), f


def test_save_snapshot_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    from civiwave_tpu_torch.post.snapshot import save_snapshot

    (mesh, pre, d_all), _ = host_pair(2, 2, 1, False)
    u = np.zeros((mesh.node_count, 3), np.float32)
    u[-1, 2] = -0.05
    fs = derived.compute_derived_fields(pre, d_all, u, mesh.node_count,
                                        mesh.element_count)
    path = tmp_path / "snap" / "s.png"
    save_snapshot(str(path), mesh, u, fs, deformation_scale=2.0, title="box")
    blob = path.read_bytes()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and len(blob) > 5000


def _probe_table(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=np.float64)


def _vtu_arrays(path):
    """{name: f32 array} of a VTU's appended Float32 blocks."""
    import re

    blob = open(path, "rb").read()
    head, data = blob.split(b'<AppendedData encoding="raw">\n_', 1)
    out = {}
    for m in re.finditer(rb'type="Float32" Name="(\w+)"[^>]*offset="(\d+)"',
                         head):
        off = int(m.group(2))
        size = int(np.frombuffer(data[off:off + 4], np.uint32)[0])
        out[m.group(1).decode()] = np.frombuffer(
            data[off + 4:off + 4 + size], np.float32)
    return out


def test_cli_output_matches_reference(tmp_path):
    """examples/cantilever_box.yaml --output, 5 frames: the same files as
    the reference runner, probe rows within the BASELINE tolerances (u at
    2.5e-4, a at 3e-3 of max|ref|, strain and stress at 3e-3 of
    max|ref|), the VTU arrays likewise."""
    ours, ref = tmp_path / "port", tmp_path / "ref"
    assert main([BOX_YAML, "--frames", "5", "--quiet", "--device", "cpu",
                 "--output", str(ours)]) == 0
    assert jmain([BOX_YAML, "--frames", "5", "--quiet", "--output", str(ref)]) == 0
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ref)
                           for d, _, fs in os.walk(ref) for f in fs)
    assert files == ["probes/probes.csv", "vtu/frame_00000.vtu"]
    head, got = _probe_table(ours / "probes" / "probes.csv")
    jhead, want = _probe_table(ref / "probes" / "probes.csv")
    assert head == jhead and got.shape == want.shape == (5, 25)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    for cols, tol in ((slice(3, 6), U_TOL), (slice(6, 12), A_TOL),
                      (slice(12, 25), A_TOL)):
        scale = np.abs(want[:, cols]).max() + 1e-30
        np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=0.0,
                                   atol=tol * scale)
    a, b = (_vtu_arrays(r / "vtu" / "frame_00000.vtu") for r in (ours, ref))
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=0.0,
                                   atol=A_TOL * (np.abs(b[name]).max() + 1e-30),
                                   err_msg=name)
