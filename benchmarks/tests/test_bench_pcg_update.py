"""The reader of ``pcg_update_roofline``: its least work on the 255^3 box
(``benchmarks/harness/work.pcg_update``), None where the direction update
did not launch, and the same number as before its count moved to
``work.py``.  CPU only.

    python -m pytest -q benchmarks/tests/test_bench_pcg_update.py
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmarks.harness.cells import metric_reader
from benchmarks.harness.trace import TraceSummary
from benchmarks.harness.work import least_seconds, pcg_update
from benchmarks.reference.mesh import parse_box

BOX = parse_box("synthetic://box/255,255,255")


def _name(first: bool) -> str:
    """The profiler's name of the kernel's f32 instance."""
    return ("void (anonymous namespace)::cg_direction_update_kernel<float, "
            f"{'true' if first else 'false'}>(float*, float*, float*, float*, "
            "float const*, float const*, unsigned char const*, void const*, "
            "void const*, int, long)")


def _ctx(kernels):
    trace = TraceSummary(wall_s=6.0, busy_s=5.0, kernels=kernels)
    return SimpleNamespace(trace=trace, box=BOX)


def test_pcg_update_counts_123_bytes_and_24_operations_a_node():
    n = 256 ** 3
    assert BOX.node_count == n
    assert pcg_update(BOX) == (123 * n, 24 * n)
    # a solve's first update reads no p and s
    assert pcg_update(BOX, first=True) == (99 * n, 12 * n)
    # 2.064 GB: bound by the memory, 0.616 ms at 3.35 TB/s
    least = least_seconds(*pcg_update(BOX))
    assert least == pytest.approx(2.0636e9 / 3.35e12, rel=1e-4)


def test_reads_none_where_the_kernel_did_not_launch():
    read = metric_reader("pcg_update_roofline")
    assert read(SimpleNamespace(trace=None, box=BOX)) is None
    k2 = "void (anonymous namespace)::pc_keff_sweep_kernel<true>(...)"
    assert read(_ctx({k2: (890_000.0, 1560)})) is None


def test_first_updates_are_charged_their_own_least_work():
    read = metric_reader("pcg_update_roofline")
    k2 = "void (anonymous namespace)::pc_keff_sweep_kernel<true>(...)"
    n = 256 ** 3
    # 100 later launches at 0.7 ms each: the least time over 0.7 ms
    share = read(_ctx({k2: (890_000.0, 1560), _name(False): (70_000.0, 100)}))
    assert share == pytest.approx(100 * 123 * n / 3.35e12 / 0.7e-3)
    # with 14 first launches at 0.6 ms: the least times summed per
    # instance over the device time of both
    share = read(_ctx({_name(True): (8_400.0, 14), _name(False): (70_000.0, 100)}))
    least = (14 * 99 * n + 100 * 123 * n) / 3.35e12
    assert share == pytest.approx(100 * least / 78.4e-3)


def test_the_reading_is_the_one_before_the_count_moved():
    """One fixed traced window of the 255^3 cell (K2, and U1's first and
    later instances): the reader gives the number it gave while the count
    lived in the reader itself, to the last digit."""
    read = metric_reader("pcg_update_roofline")
    k2 = "void (anonymous namespace)::pc_keff_sweep_kernel<true>(...)"
    trace = TraceSummary(wall_s=6.0, busy_s=5.33, kernels={
        k2: (1_410_000.0, 2275), _name(True): (160_000.0, 287),
        _name(False): (1_340_000.0, 1992)})
    assert read(SimpleNamespace(trace=trace, box=BOX)) == 91.29109241122389
