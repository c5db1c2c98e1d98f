"""The trace reduction on a made-up event list: kernels tied to the
profiler range whose host span holds their launch, device-side copies of
host ranges left out, busy time as the union of the device's events."""
import types

import pytest

from torch.autograd import DeviceType

from benchmark.harness.trace import Trace


class _Event:
    """A profiler event as ``kineto_results`` gives it, with its activity
    type."""

    def __init__(self, name, kind, start, dur, corr):
        self._v = (name, kind, start, dur, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return DeviceType.CPU if self._v[1] in (
            'user_annotation', 'cuda_runtime', 'cpu_op') else DeviceType.CUDA

    def is_user_annotation(self):
        return self._v[1] in ('user_annotation', 'gpu_user_annotation')

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


class _UntypedEvent(_Event):
    """The same as older versions of torch give it: its device type and
    whether it is a range, and no activity type."""
    activity_type = None


@pytest.mark.parametrize('typed', [True, False])
def test_trace_ties_kernels_to_ranges_and_skips_range_copies(typed):
    rows = [
        ('train_step.diffusion', 'user_annotation', 0, 1000, 1),
        ('cudaLaunchKernel', 'cuda_runtime', 100, 10, 7),
        ('nccl:all_reduce', 'user_annotation', 500, 100, 2),
        ('cudaLaunchKernel', 'cuda_runtime', 2000, 10, 8),
        ('gemm_kernel', 'kernel', 200, 300, 7),
        ('ncclDevKernel_AllReduce', 'kernel', 600, 50, 9),
        ('nccl:all_reduce', 'gpu_user_annotation', 600, 50, 3),
        ('train_step.diffusion', 'gpu_user_annotation', 150, 400, 4),
        # a host op and a kernel of one name: the kernel is work
        ('fill_kernel', 'cpu_op', 2050, 10, 10),
        ('fill_kernel', 'kernel', 2300, 100, 8),
        ('late_kernel', 'kernel', 2100, 100, 8),
    ]
    events = [(_Event if typed else _UntypedEvent)(*r) for r in rows]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    trace = Trace(prof, 0, 3000, ('train_step.diffusion',))
    names = [d[0] for d in trace.device]
    assert names == ['gemm_kernel', 'ncclDevKernel_AllReduce', 'late_kernel',
                     'fill_kernel']
    assert trace.skipped == {'nccl:all_reduce': 1, 'train_step.diffusion': 1}
    parts = trace.range_seconds()
    assert parts['train_step.diffusion'] == pytest.approx(300e-9)
    assert parts['outside'] == pytest.approx(250e-9)
    assert trace.busy_s == pytest.approx(550e-9)
    assert trace.device_seconds(lambda n: 'nccl' in n.lower()) == \
        pytest.approx(50e-9)
