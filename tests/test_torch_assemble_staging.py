"""The staging geometry of the CSR assembly kernel G1
(``ops/cuda/assemble_csr.staging_geometry``), checked on the CPU: each
block of nodes stages its slice of ``csr_idx`` and ``csr_weight`` as rows
of an odd number of 16-byte chunks, within one H100 block's shared memory,
and the blocks cover every node once, for the degrees the general meshes
reach (8 on hex boxes, 24 on tet boxes, more on mixed and Gmsh meshes)."""

import os

import numpy as np
import pytest

from civiwave_tpu_torch.mesh import pack, preprocess
from civiwave_tpu_torch.ops.cuda import assemble_csr as g1
from civiwave_tpu_torch.physics import materials
from civiwave_tpu_torch.runner import build_simulation
from civiwave_tpu_torch.utils.synthetic import (
    box_mesh,
    cantilever_config,
    split_last_hex,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bank_groups_distinct(chunks):
    """Eight consecutive rows' chunk q fall in eight distinct 16-byte bank
    groups of shared memory (one quarter warp of int4 / float4 reads)."""
    for q in range(chunks):
        groups = {(t * chunks + q) % 8 for t in range(8)}
        if len(groups) != 8:
            return False
    return True


@pytest.mark.parametrize("degree, chunks", [(8, 3), (24, 7), (32, 9)])
@pytest.mark.parametrize("nodes", [1, 127, 128, 129, 300_763])
def test_staging_geometry(nodes, degree, chunks):
    geom = g1.staging_geometry(nodes, degree)
    assert geom.row_chunks == chunks and geom.row_chunks % 2 == 1
    assert 4 * geom.row_chunks >= degree
    assert _bank_groups_distinct(geom.row_chunks)
    assert geom.threads == g1.ASSEMBLE_NODES and geom.threads % 32 == 0
    assert geom.smem_bytes == 2 * geom.threads * geom.row_chunks * 16
    assert geom.smem_bytes <= g1.SMEM_LIMIT
    # every node in exactly one block, the last one ragged
    assert (geom.blocks - 1) * geom.threads < nodes <= geom.blocks * geom.threads


def test_staging_geometry_unpadded_rows_would_conflict():
    """Why the rows are padded: unpadded rows of an even chunk count put
    two (D = 24) or eight (D = 32) rows of a quarter warp in one bank group."""
    assert not _bank_groups_distinct(6) and not _bank_groups_distinct(8)


def test_staging_geometry_large_degree_and_refusals():
    """A degree whose staged block would not fit halves the block; a degree
    that is not a multiple of 4, or too large for 32 nodes, is refused."""
    geom = g1.staging_geometry(1000, 512)
    assert geom.threads < g1.ASSEMBLE_NODES and geom.threads % 32 == 0
    assert geom.smem_bytes <= g1.SMEM_LIMIT
    assert geom.blocks * geom.threads >= 1000
    for degree in (0, 6, 26):
        with pytest.raises(ValueError):
            g1.staging_geometry(100, degree)
    with pytest.raises(ValueError):
        g1.staging_geometry(100, 4 * 1000)


def _packed(mesh, cfg):
    pre = preprocess.run(mesh, cfg)
    mats = [materials.make_properties(m) for m in cfg.materials]
    model, _, _ = pack.build_packed_model(mesh, pre, cfg, mats, device="cpu")
    return model


@pytest.mark.parametrize("case", ["hex", "tet", "mixed", "seismic_column"])
def test_staging_geometry_of_the_general_meshes(case):
    """The degrees the general path's meshes reach, each a multiple of 8
    that G1 stages within its shared memory."""
    if case == "seismic_column":  # a Gmsh tet mesh, two materials
        model = build_simulation(
            os.path.join(REPO, "examples", "seismic_column_tet.yaml"),
            device="cpu").model
    else:
        mesh = {"hex": lambda: box_mesh(4, 4, 4, hex_elements=True),
                "tet": lambda: box_mesh(4, 4, 4),
                "mixed": lambda: split_last_hex(
                    box_mesh(4, 4, 4, hex_elements=True))}[case]()
        model = _packed(mesh, cantilever_config())
    degree = model.csr_degree
    want = {"hex": 8, "tet": 24}
    if case in want:
        assert degree == want[case]
    assert degree % 8 == 0
    counts = np.count_nonzero(model.csr_weight.numpy(), axis=1)
    assert counts.max() <= degree
    geom = g1.staging_geometry(model.padded_node_count, degree)
    assert geom.smem_bytes <= g1.SMEM_LIMIT
    assert geom.blocks * geom.threads >= model.padded_node_count
