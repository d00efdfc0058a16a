"""The yardstick's counts against hand counts, and the trace reader on a
made-up stretch."""
from __future__ import annotations

import pytest

from portbench.lib import trace, work


def test_attention_counts():
    fwd = work.attention_fwd(2, 3, 5, 1, "bfloat16", save_p=True)
    # Q, K, V, O: 2 bytes x 64 x (2·2·3 + 2·2·5); P: 2 bytes x 2·1·3·5
    assert fwd.nbytes == 2 * 64 * (12 + 20) + 2 * 30
    assert fwd.flops == 2 * 2 * (2 * 3 * 5 * 64)            # QKᵀ and P·V
    bwd = work.attention_bwd(2, 3, 5, 1, "bfloat16")
    # P read; dO, Q, dQ over the queries; K, V, dK, dV over the keys
    assert bwd.nbytes == 2 * (30 + 64 * (3 * 2 * 3 + 4 * 2 * 5))
    assert bwd.flops == 4 * 2 * (2 * 3 * 5 * 64)            # dV, dP, dQ, dK
    causal = work.attention_fwd(2, 3, 3, 1, "float32", save_p=False, bias2d=True)
    assert causal.nbytes == 4 * 64 * (12 + 12) + 4 * 9


def test_grouping_counts():
    ev = work.grouping(2, 4, 6, 8, "float32", training=False)
    # q and out (N, G, D), k and v (N, L, D), hard and soft (N, G, L) fp32
    assert ev.nbytes == 4 * (2 * 2 * 4 * 8 + 2 * 2 * 6 * 8) + 4 * 2 * 4 * 6 * 2
    assert ev.flops == 2 * (2 * 2 * 4 * 6 * 8)              # q·kᵀ and hard·v
    tr = work.grouping(2, 4, 6, 8, "bfloat16", training=True)
    assert tr.nbytes == 2 * (2 * 2 * 4 * 8 + 2 * 2 * 6 * 8) + 4 * 2 * 4 * 6 * 4


def test_least_time_takes_the_larger_bound():
    big_bytes = work.Call("x", work.HBM_BYTES_PER_S, 1.0, "bfloat16")
    big_ops = work.Call("y", 1.0, work.PEAK_FLOPS["float32"] * 2, "float32")
    assert work.least_seconds([big_bytes]) == pytest.approx(1.0)
    assert work.least_seconds([big_bytes, big_ops]) == pytest.approx(3.0)


def test_trace_summary_busy_idle_and_names():
    iv = trace.Interval
    s = trace.Summary((0, 100), [iv("a", 10, 30), iv("void segclip_kernels::k", 20, 40),
                                 iv("b", 60, 70)], [iv("aten::mm", 40, 60)])
    assert s.busy_s == pytest.approx(40e-9) and s.window_s == pytest.approx(100e-9)
    assert s.device_seconds(port=True) == pytest.approx(20e-9)
    assert s.device_seconds(port=False) == pytest.approx(30e-9)
    gaps = s.idle_gaps()
    assert gaps[0] == ["host_outside_torch_operations", pytest.approx(30e-9)]
    assert ["aten::mm", pytest.approx(20e-9)] in gaps


class _Event:
    def __init__(self, name, start, end, cuda=True):
        self._n, self._s, self._d, self._cuda = name, start, end - start, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_device_stretch_runs_between_its_markers():
    """The span runs from the opening marker's end to the closing one's
    start; the markers are not work, host events are not device work."""
    events = [_Event("marker", 0, 5), _Event("gemm", 10, 30), _Event("cudaLaunch", 8, 9, False),
              _Event("segclip_kernels::attn", 40, 50), _Event("marker", 95, 97)]
    s = trace.device_summary(_Prof(events))
    assert s.span == (5, 95) and s.window_s == pytest.approx(90e-9)
    assert s.busy_s == pytest.approx(30e-9)
    assert s.device_seconds(port=True) == pytest.approx(10e-9)
    assert [name for name, _ in s.top_ops()] == ["gemm", "segclip_kernels::attn"]


def test_stretches_cover_their_units():
    import torch
    st = trace.Stretches(2, 3, torch.device("cpu"))
    assert [i for i in range(10) if st.profiled(i)] == [2, 3, 4, 5, 6, 7]
    for i in range(10):
        st.before(i)
    assert st.done and st.summary is None and st.host is not None
