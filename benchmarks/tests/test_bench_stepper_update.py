"""The reader of ``stepper_update_roofline``: the least work of the
stepper's three passes on the 255^3 box (88, 39 and 84 B a node in f32),
each instance's own where the clamp adds an absorbing term or the update
writes delta, and None where none of them launched.  CPU only.

    python -m pytest -q benchmarks/tests/test_bench_stepper_update.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmarks.harness.cells import metric_reader
from benchmarks.harness.trace import TraceSummary
from benchmarks.reference.mesh import parse_box

BOX = parse_box("synthetic://box/255,255,255")
N = 256 ** 3
K2 = "void (anonymous namespace)::pc_keff_sweep_kernel<true>(...)"


def _name(kernel: str, *args: str, t: str = "float") -> str:
    """The profiler's name of an instance on the grid."""
    return (f"void (anonymous namespace)::{kernel}<{', '.join((t, 'true', *args))}>"
            f"((anonymous namespace)::Args<{t}>)")


def _ctx(kernels):
    trace = TraceSummary(wall_s=6.0, busy_s=5.0, kernels=kernels)
    return SimpleNamespace(trace=trace, box=BOX)


def test_reads_none_where_no_pass_launched():
    read = metric_reader("stepper_update_roofline")
    assert read(SimpleNamespace(trace=None, box=BOX)) is None
    assert read(_ctx({K2: (890_000.0, 1560)})) is None


def test_the_three_passes_are_charged_211_bytes_a_node():
    read = metric_reader("stepper_update_roofline")
    # 100 frames, each pass at 0.4 ms: 3.54 GB over 120 ms
    share = read(_ctx({
        K2: (890_000.0, 1560),
        _name("newmark_rhs_kernel"): (40_000.0, 100),
        _name("newmark_rhs_clamp_kernel", "true", "false"): (40_000.0, 100),
        _name("newmark_update_kernel", "false"): (40_000.0, 100)}))
    assert share == pytest.approx(100 * 100 * 211 * N / 3.35e12 / 0.12)
    assert 211 * N / 3.35e12 == pytest.approx(1.057e-3, rel=1e-3)


@pytest.mark.parametrize("kernel,args,nbytes", [
    ("newmark_rhs_clamp_kernel", ("false", "false"), 27),
    ("newmark_rhs_clamp_kernel", ("true", "true"), 51),
    ("newmark_update_kernel", ("true",), 96),
])
def test_each_instance_is_charged_its_own_bytes(kernel, args, nbytes):
    read = metric_reader("stepper_update_roofline")
    share = read(_ctx({_name(kernel, *args): (10_000.0, 10)}))
    assert share == pytest.approx(100 * 10 * nbytes * N / 3.35e12 / 0.01)


def test_f64_instances_move_24_bytes_a_value_triple():
    read = metric_reader("stepper_update_roofline")
    share = read(_ctx({_name("newmark_rhs_kernel", t="double"): (10_000.0, 10)}))
    assert share == pytest.approx(100 * 10 * 172 * N / 3.35e12 / 0.01)
