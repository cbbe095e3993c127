"""The plane sweeps' interior stencil in its symmetry-factored form
(``ops.structured.factored_taps``, ``csrc/structured.cuh``
``add_plane_factored``), checked on the CPU: the 30 coefficients rebuild
the f64 interior row of the class table for several spacings and
materials, the 153 taps that are not zero in structure, a table whose
symmetry is broken is refused, the z-face ghost taps turn the factored
interior into the class rows, and a numpy emulation of the kernels' plane
loop (the factored interior where the kernels take it, the class table
elsewhere) gives the plain operator."""

import numpy as np
import pytest
import torch

from civiwave_tpu_torch.mesh.structured import build_structured_model
from civiwave_tpu_torch.ops import structured as tops
from civiwave_tpu_torch.ops.cuda import plane_sweep
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.utils.synthetic import cantilever_config


def _lame(e_mod, nu):
    return (e_mod * nu / ((1 + nu) * (1 - 2 * nu)), e_mod / (2 * (1 + nu)))


SPACINGS = {"unit": (1.0, 1.0, 1.0), "half": (0.5, 0.5, 0.5),
            "mixed": (1.0, 0.5, 2.0)}
# the cantilever's steel, the hetero cell's rock and soil, a nearly
# incompressible solid
MATERIALS = {"steel": _lame(2e11, 0.3), "rock": _lame(5e10, 0.25),
             "soil": _lame(2e8, 0.35), "nu_0.49": _lame(2e11, 0.49)}


def _row64(spacing, lam, mu):
    return tops._class_stencil_table64(spacing, lam, mu)[13].reshape(
        3, 3, 3, 3, 3)


@pytest.mark.parametrize("spacing", sorted(SPACINGS))
@pytest.mark.parametrize("material", sorted(MATERIALS))
def test_factored_taps_rebuild_the_interior_row(spacing, material):
    h, (lam, mu) = SPACINGS[spacing], MATERIALS[material]
    coef = tops.factored_taps(h, lam, mu)
    assert coef.shape == (plane_sweep.FACTORED_TAPS,)
    assert coef.dtype == np.float64
    row = _row64(h, lam, mu)
    np.testing.assert_allclose(tops.expand_factored(coef), row, rtol=0,
                               atol=1e-12 * np.abs(row).max())
    # every coefficient carries a tap of the row
    assert np.all(np.abs(coef) > 1e-6 * np.abs(row).max())


def test_structural_zero_pattern():
    """153 of the 243 taps are not zero in structure: all 27 of each
    diagonal block, and 12 of each of the six coupling blocks (odd along
    both of its axes, so zero wherever either offset is 0); the f64 row
    holds assembly noise at most 1e-12 of its largest tap elsewhere."""
    pattern = tops.expand_factored(np.ones(plane_sweep.FACTORED_TAPS)) != 0
    assert pattern.sum() == 153
    for b in range(3):
        assert pattern[..., b, b].all()
    for b, c in ((0, 1), (0, 2), (1, 2)):
        assert pattern[..., b, c].sum() == pattern[..., c, b].sum() == 12
    d = np.indices((3, 3, 3)) - 1  # (dx, dy, dz) offsets
    assert np.array_equal(pattern[..., 0, 1], (d[0] != 0) & (d[1] != 0))
    assert np.array_equal(pattern[..., 0, 2], (d[0] != 0) & (d[2] != 0))
    assert np.array_equal(pattern[..., 1, 2], (d[1] != 0) & (d[2] != 0))
    for h in SPACINGS.values():
        row = _row64(h, *MATERIALS["steel"])
        big = np.abs(row) > 1e-12 * np.abs(row).max()
        assert np.array_equal(big, pattern)


@pytest.mark.parametrize("fault", ["asymmetric", "structural_zero"])
def test_broken_symmetry_raises(monkeypatch, fault):
    lam, mu = MATERIALS["steel"]
    table = tops._class_stencil_table64((1.0, 1.0, 1.0), lam, mu).copy()
    row = table[13].reshape(3, 3, 3, 3, 3)
    scale = np.abs(row).max()
    if fault == "asymmetric":  # one diagonal tap off its mirror image
        row[2, 1, 1, 0, 0] += 1e-6 * scale
    else:  # an x-y coupling tap at dx = 0
        row[1, 2, 1, 0, 1] = 1e-6 * scale
    monkeypatch.setattr(tops, "_class_stencil_table64",
                        lambda spacing, lam0, mu0: table)
    with pytest.raises(ValueError, match=r"spacing \(1.0, 1.0, 1.0\)"):
        tops.factored_taps.__wrapped__((1.0, 1.0, 1.0), lam, mu)


@pytest.mark.parametrize("side, cls", [(0, 12), (1, 14)], ids=["z0", "z1"])
@pytest.mark.parametrize("spacing", sorted(SPACINGS))
def test_z_face_ghost_taps_give_the_class_rows(side, cls, spacing):
    """The factored interior the kernels apply minus a z face's ghost taps
    is the face class's row at dz = 0: to the f32 ghost taps' rounding in
    the f32 instance, exactly in the f64 one (against the f32 table)."""
    h = SPACINGS[spacing]
    lam, mu = MATERIALS["steel"]
    n = plane_sweep.FACTORED_TAPS
    taps32 = tops.sweep_taps(h, lam, mu)
    assert taps32.shape == (plane_sweep.SWEEP_TAPS,)
    assert taps32.dtype == np.float32
    interior = tops.expand_factored(taps32[:n].astype(np.float64))[:, :, 1]
    ghost = taps32[n:].reshape(2, 3, 3, 3, 3)[side].astype(np.float64)
    table64 = tops._class_stencil_table64(h, lam, mu).reshape(
        27, 3, 3, 3, 3, 3)
    want = table64[cls][:, :, 1]
    np.testing.assert_allclose(interior - ghost, want, rtol=0,
                               atol=2.0 ** -23 * np.abs(want).max())
    taps64 = plane_sweep._taps64(h, lam, mu)
    np.testing.assert_array_equal(taps64[:n], taps32[:n].astype(np.float64))
    table32 = tops.class_stencil_table(h, lam, mu).reshape(27, 3, 3, 3, 3, 3)
    ghost64 = taps64[n:].reshape(2, 3, 3, 3, 3)[side]
    np.testing.assert_array_equal(interior - ghost64,
                                  table32[cls][:, :, 1].astype(np.float64))


# --- a numpy emulation of the kernels' plane loop --------------------------


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _groups(p, comp):
    """Groups<kC> of structured.cuh on a padded (Y + 2, Z + 2) plane, at
    every node of the (Y, Z) interior."""
    def at(dy, dz):
        return p[1 + dy:p.shape[0] - 1 + dy, 1 + dz:p.shape[1] - 1 + dz]

    mm, m0, mp = at(-1, -1), at(-1, 0), at(-1, 1)
    cm, c0, cp = at(0, -1), at(0, 0), at(0, 1)
    pm, p0, pp = at(1, -1), at(1, 0), at(1, 1)
    g = {"c": c0, "ys": m0 + p0, "zs": cm + cp}
    if comp != 2:
        lo, hi = mm + mp, pm + pp
        g.update(cs=lo + hi, cyd=hi - lo, yd=p0 - m0)
    if comp != 1:
        lo, hi = mm + pm, mp + pp
        if comp == 2:
            g["cs"] = lo + hi
        g.update(czd=hi - lo, zd=cp - cm)
    if comp != 0:
        g["yz"] = (mm + pp) - (mp + pm)
    return g


def _diagonal(k, comp, a, g, s):
    d = k[(comp * 2 + a) * 4:(comp * 2 + a) * 4 + 4]
    for coef, key in zip(d, ("c", "ys", "zs", "cs")):
        s = _fma(coef, g[key], s)
    return s


def _add_plane_factored(p3, k, acc):
    """add_plane_factored on the padded transformed plane p3 (3, Y + 2,
    Z + 2): acc[n] (3, Y, Z) the outputs at x = j - 1 + n."""
    g0, g1, g2 = (_groups(p3[c], c) for c in range(3))
    o0 = _fma(k[27], g2["czd"], _fma(k[26], g2["zd"], _fma(
        k[25], g1["cyd"], k[24] * g1["yd"])))
    o1 = _fma(k[25], g0["cyd"], k[24] * g0["yd"])
    o2 = _fma(k[27], g0["czd"], k[26] * g0["zd"])
    zero = np.zeros_like(g0["c"])
    e = [_diagonal(k, 0, 1, g0, zero), _diagonal(k, 1, 1, g1, k[29] * g2["yz"]),
         _diagonal(k, 2, 1, g2, k[29] * g1["yz"])]
    acc[1][0] = _diagonal(k, 0, 0, g0, acc[1][0])
    acc[1][1] = _diagonal(k, 1, 0, g1, _fma(k[28], g2["yz"], acc[1][1]))
    acc[1][2] = _diagonal(k, 2, 0, g2, _fma(k[28], g1["yz"], acc[1][2]))
    for b, o in enumerate((o0, o1, o2)):
        acc[0][b] = acc[0][b] + (e[b] + o)
        acc[2][b] = acc[2][b] + (e[b] - o)


def _add_plane_table(p3, rows, acc):
    """add_plane with per-node class rows ``rows[n]`` (Y, Z, 27, 3, 3)."""
    Y, Z = acc[0].shape[1:]
    for n in range(3):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                v = p3[:, 1 + dy:1 + dy + Y, 1 + dz:1 + dz + Z]
                d = ((2 - n) * 3 + dy + 1) * 3 + dz + 1
                taps = rows[n][:, :, d]  # (Y, Z, 3, 3)
                for b in range(3):
                    for c in range(3):
                        acc[n][b] = _fma(taps[..., b, c], v[c], acc[n][b])


def emulated_stiffness(model, u):
    """K(u) in f32 as the plane sweep computes it, every node's planes
    j = x - 1, x, x + 1 in that order: where the node's row and the three
    output planes of plane j are of the interior class, the factored
    interior (z-face columns then subtract their ghost taps at dz = 0),
    else the class table."""
    X, Y, Z = model.grid_shape
    nx, ny, nz = model.nx, model.ny, model.nz
    taps = np.asarray(model.sweep_taps, np.float32)
    k = taps[:plane_sweep.FACTORED_TAPS]
    gz = taps[plane_sweep.FACTORED_TAPS:].reshape(2, 3, 3, 3, 3)
    table = model.stencil_table.numpy()
    cy = tops.axis_classes(Y, ny)
    cz = tops.axis_classes(Z, nz)
    cx = tops.axis_classes(X + 2, nx, -1)  # planes -1 .. X
    out = np.zeros((3, X, Y, Z), np.float32)
    window = [np.zeros((3, Y, Z), np.float32) for _ in range(3)]
    for j in range(X):
        p3 = np.pad(u[:, j], ((0, 0), (1, 1), (1, 1)))
        plane_cls = cx[j:j + 3]  # outputs j - 1, j, j + 1
        rows = [table[(plane_cls[n] * 3 + cy[:, None]) * 3 + cz[None, :]]
                for n in range(3)]
        fact = [np.zeros((3, Y, Z), np.float32) for _ in range(3)]
        tab = [w.copy() for w in window]
        if (plane_cls == 1).all():
            fact = [w.copy() for w in window]
            _add_plane_factored(p3, k, fact)
            for col in (0, Z - 1):  # a z-face column's class picks its side
                side = {0: 0, 2: 1}[cz[col]]
                for n in range(3):
                    for dy in (-1, 0, 1):
                        v = -p3[:, 1 + dy:1 + dy + Y, 1 + col]
                        g = gz[side][2 - n, dy + 1]
                        for b in range(3):
                            for c in range(3):
                                fact[n][b][:, col] = _fma(
                                    g[b, c], v[c], fact[n][b][:, col])
        _add_plane_table(p3, rows, tab)
        use = ((cy == 1)[:, None] & (plane_cls == 1).all())[None]
        window = [np.where(use, f, t) for f, t in zip(fact, tab)]
        if j >= 1:
            out[:, j - 1] = window[0]
        window = [window[1], window[2], np.zeros((3, Y, Z), np.float32)]
    out[:, X - 1] = window[0]
    return out


@pytest.mark.parametrize("spacing", ["unit", "mixed"])
def test_emulated_factored_sweep_matches_the_plain_operator(spacing):
    """A 9 x 13 x 37-cell grid (faces on every axis, z-face columns in
    interior rows): the emulated sweep against the plain operator at 1e-6
    of max|ref|, and its factored branch taken at most node-plane visits."""
    cfg = cantilever_config()
    mat = cfg.materials[0]
    model, _ = build_structured_model(
        9, 13, 37, materials.make_properties(mat), mat.density,
        spacing=SPACINGS[spacing], fixed_axis_planes=(), device="cpu")
    rng = np.random.default_rng(26)
    u = rng.standard_normal(model.vector_shape).astype(np.float32)
    ref = tops.apply_keff_structured_plain(
        model, torch.as_tensor(u), 1.0, 0.0).numpy()
    got = emulated_stiffness(model, u)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    geom = plane_sweep.sweep_geometry(model.grid_shape, 1)
    factored, total = plane_sweep.factored_visits(
        geom, model.grid_shape, (model.nx, model.ny, model.nz))
    assert 0 < factored < total


def test_factored_visits_at_255_cubed():
    """The share of (node, plane) visits of a 255^3 sweep on the factored
    branch: 266 of 270 plane visits (8 chunks of 32 planes plus their
    halos; planes 2-253 have interior output planes) times 254 of 256
    rows."""
    geom = plane_sweep.sweep_geometry((256, 256, 256), 1)
    factored, total = plane_sweep.factored_visits(
        geom, (256, 256, 256), (255, 255, 255))
    assert total == 270 * 256 * 256
    assert factored == 266 * 254 * 256
    assert round(factored / total, 4) == 0.9775
