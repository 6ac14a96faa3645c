"""The trace reading on a small synthetic Chrome trace: device events with
their launching ops and hand-kernel names, the traced window from the
phase spans, busy time as a union, and the idle gaps by what ended them."""

import pytest

from perfbench import tracing

KERNELS = ("mega_stage", "geom_conv")
MEGA = "void mega_stage_kernel<float, 3, 4, 6, false>(Args<float, 3, false>)"


def _trace():
    def x(cat, name, ts, dur, **args):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1,
                    tid=1, args=args)
    return {"traceEvents": [
        x("user_annotation", tracing.PHASE_SPAN, 0, 100),
        x("cpu_op", "aten::mul", 5, 10),
        x("cuda_runtime", "cudaLaunchKernel", 6, 2, correlation=1),
        x("kernel", "elementwise_kernel<float>", 20, 10, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 30, 2, correlation=2),
        x("kernel", MEGA, 25, 30, correlation=2),
        x("kernel", MEGA, 70, 10, correlation=3),
        x("gpu_memcpy", "Memcpy DtoH", 90, 5, correlation=4),
    ]}


def test_events_and_window():
    tr = tracing.Trace(_trace(), KERNELS)
    assert [o["label"] for o in tr.events] == [
        "aten::mul", "mega_stage", "mega_stage", "(gpu_memcpy)"]
    assert tr.kernel_counts() == {"mega_stage": 2, "geom_conv": 0}
    assert tr.durations("mega_stage") == [30.0, 10.0]
    assert tr.n_phases == 1 and tr.window_s() == pytest.approx(1e-4)
    # [20, 55] u [70, 80] u [90, 95]
    assert tr.busy_s() == pytest.approx(50e-6)


def test_breakdown():
    tr = tracing.Trace(_trace(), KERNELS)
    ops = dict(tr.device_ops())
    assert ops["mega_stage"] == pytest.approx(40e-6)
    gaps = dict(tr.idle_gaps())
    # 0-20 ends at aten::mul's kernel, 55-70 and 80-90 at a mega_stage and
    # the copy, 95-100 at the end of the phase
    assert gaps == pytest.approx({"aten::mul": 20e-6, "mega_stage": 15e-6,
                                  "(gpu_memcpy)": 10e-6,
                                  "(end of phase)": 5e-6})
