"""The trace reduction: busy time as the union of kernel intervals (never
their sum), idle gaps named by the host's outermost operation, the costliest
device operations."""

import pytest

from benchmark.trace import Trace, union_seconds


def test_union_counts_overlap_once_and_clips_to_the_window():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (100, 200)]
    assert union_seconds(iv, (0, 50)) == pytest.approx(25e-9)
    assert union_seconds(iv, (8, 22)) == pytest.approx(9e-9)
    assert union_seconds([], (0, 10)) == 0.0


def test_busy_idle_and_gaps_on_a_made_up_trace():
    # two streams overlap on [5, 10); copies are not kernels
    tr = Trace(kernels=[("a(int)", 0, 10), ("b", 5, 15), ("a(int)", 40, 50)],
               copies=[("Memcpy HtoD", 15, 40)],
               host=[("aten::to", 12, 38), ("cudaStreamSynchronize", 45, 60)],
               window=(0, 70))
    assert tr.busy_s() == pytest.approx(25e-9)
    gaps = dict(tr.idle_gaps())
    # gap [15, 40): aten::to until 38, then Python; gap [50, 70): the sync
    # until 60, then Python
    assert gaps == pytest.approx({"aten::to": 23e-9, "host Python": 12e-9,
                                  "cudaStreamSynchronize": 10e-9})
    ops = dict(tr.device_ops())
    assert ops == pytest.approx({"a": 20e-9, "b": 10e-9,
                                 "Memcpy HtoD": 25e-9})


def test_a_gap_outside_any_host_operation_is_host_python():
    tr = Trace(kernels=[("k", 0, 10)], host=[("aten::add", 2, 4),
                                             ("aten::mul", 12, 15)],
               window=(0, 30))
    assert dict(tr.idle_gaps()) == pytest.approx({"host Python": 17e-9,
                                                  "aten::mul": 3e-9})
