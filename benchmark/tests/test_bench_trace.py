"""The trace reading on a chrome trace worked out by hand."""
import pytest

from benchmark import trace


def ev(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def test_summarize_by_hand():
    events = [
        ev("cpu_op", "aten::item", 0, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 5),
        ev("kernel", "void (anonymous namespace)::fused_rounds_kernel<true, 0>", 20, 30),
        ev("kernel", "void at::native::reduce_kernel<512>", 40, 20),  # overlaps: union 20-60
        ev("gpu_memcpy", "Memcpy DtoH", 70, 10),  # gap 60-70: aten::item holds it
        ev("cpu_op", "aten::nonzero", 150, 10),
        ev("kernel", "void at::native::index_kernel", 200, 20),  # gap 80-200: between ops
        ev("kernel", "void (anonymous namespace)::fused_rounds_kernel<true, 0>", 230, 10),
        ev("i", "instant", 0, 0),
    ]
    s = trace.summarize(events, windows=2, wall_s=400e-6)
    assert s.busy_s == pytest.approx((40 + 10 + 20 + 10) * 1e-6)
    assert s.fused_kernels == 2 and s.other_kernels == 2
    assert s.fused_s == pytest.approx(40e-6)
    assert s.device_ops[0][0] == "void (anonymous namespace)::fused_rounds_kernel<true, 0>"
    assert s.device_ops[0][1] == pytest.approx(40e-6)
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps == pytest.approx({"aten::item": 10e-6,
                                  "between operations, before aten::nonzero": 120e-6,
                                  "between operations, before the end": 10e-6})


def test_merge():
    assert trace._merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
