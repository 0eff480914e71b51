"""The trace reduction on a hand-made profiler record: busy time as the
union of device intervals (annotations' device copies left out), launches,
the device time each span launched, idle gaps by the host operation that
ran during them; and the roofline's byte count of a frame."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

from portbench import roofline, trace
from portbench.scene import spec


def event(name, start, end, device=False, kernels=(), annotation=False, eid=0):
    e = FunctionEvent(id=eid, name=name, thread=0, start_us=start, end_us=end,
                      device_type=DeviceType.CUDA if device else DeviceType.CPU,
                      is_user_annotation=annotation)
    for k_name, k_us in kernels:
        e.append_kernel(k_name, 0, k_us)
    return e


def test_reduce_events():
    events = [
        event("portbench.stretch", 0, 1000, annotation=True),
        event("portbench.stretch", 0, 1000, device=True, annotation=True),
        event("portbench.render", 100, 300, annotation=True,
              kernels=[("reze::frame_kernel", 50), ("portbench.render", 200)]),
        event("aten::add", 120, 140, kernels=[("add_kernel", 10)]),
        event("aten::mul", 400, 420, kernels=[("mul_kernel", 20)]),
        event("cudaLaunchKernel", 125, 130),
        event("cudaLaunchKernel", 150, 155),
        event("cudaLaunchKernel", 405, 410),
        event("aten::item", 500, 900),
        event("add_kernel", 140, 150, device=True),
        event("reze::frame_kernel", 150, 200, device=True),
        event("reze::frame_kernel", 190, 210, device=True),
        event("mul_kernel", 430, 450, device=True),
        event("Activity Buffer Request", 600, 700, device=True),
    ]
    r = trace.reduce_events(events, spans=("render",))
    assert r["wall_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((70 + 20) * 1e-6)  # [140, 210] and [430, 450]
    assert r["launches"] == 3
    assert r["span_device_s"]["render"] == pytest.approx(60e-6)  # frame 50 + add 10
    assert r["device_ops"][0] == ["reze::frame_kernel", pytest.approx(70e-6)]
    assert r["kernel_median_ms"] == {"reze::frame_kernel": pytest.approx(0.035)}
    assert r["idle_gaps"][0] == ["aten::item", pytest.approx(550e-6)]  # [450, 1000]
    assert [g[1] for g in r["idle_gaps"]] == sorted((g[1] for g in r["idle_gaps"]), reverse=True)


def test_reduce_events_without_device_operations():
    assert trace.reduce_events([event("portbench.stretch", 0, 10, annotation=True)]) is None


def test_frame_bytes_count_the_inputs_and_the_output():
    model = spec.make_pmx_spec(0, "flagship").model
    assert roofline.pass_triangles(model) == [26583, 928, 19900, 1347, 1347, 4875, 3315]
    material = (26583 + 928 + 1347 + 4875) * 3 * 9 * 4
    outline = (19900 + 1347 + 3315) * 3 * 4 * 4
    assert roofline.frame_bytes(model, 1920, 1080) == material + outline + 1920 * 1080 * 12
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
