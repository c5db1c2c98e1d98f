"""The reduction of a ``torch.profiler`` trace of the measured window.

It reads the profiler's raw events (``kineto_results``; building
``FunctionEvent`` objects would take minutes for a window of hundreds of
thousands of ops) and keeps:

- each device event (kernel, copy, set) with its start, end and the host
  time of its launch (by correlation id);
- the host spans of named profiler ranges (the port's ``train_step.*``
  ranges, the benchmark's own);
- the host ops, to name what the host was doing while the device idled.

``busy_s`` is the union of the device events' intervals; the idle gaps
are the holes in that union inside the window."""
import bisect
import time
from contextlib import contextmanager

from torch.autograd import DeviceType

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_ACTIVITIES = ('cuda_runtime', 'cuda_driver')


def _kind(event):
    """'device' (a kernel, copy or set on the device), 'launch' (a CUDA API
    call, tied to what it launched by correlation id), 'skip' (a Python
    frame, or a range's copy on the device's timeline: a
    ``record_function`` range of the port, or c10d's ``nccl:<op>``) or
    'host' (an op or a range).  Versions of torch without the event's
    activity type (2.11) tell the device's events by their device type
    and the ranges' copies by ``is_user_annotation``."""
    activity = getattr(event, 'activity_type', None)
    if activity is None:
        if event.device_type() != DeviceType.CPU:
            return 'skip' if event.is_user_annotation() else 'device'
        return 'launch' if event.name().startswith(('cuda', 'cu')) \
            else 'host'
    activity = activity()
    if activity in DEVICE_ACTIVITIES:
        return 'device'
    if activity in LAUNCH_ACTIVITIES:
        return 'launch'
    if activity == 'python_function' or activity.startswith('gpu'):
        return 'skip'
    return 'host'


class Trace:

    def __init__(self, prof, start_ns, end_ns, ranges=()):
        self.start_ns, self.end_ns = start_ns, end_ns
        self.window_s = (end_ns - start_ns) / 1e9
        events = prof.profiler.kineto_results.events()
        host, launches, spans, device = [], {}, [], []
        self.skipped = {}   # name: count of the events left out
        for e in events:
            kind = _kind(e)
            if kind == 'device':
                device.append(e)
                continue
            if kind == 'skip':
                self.skipped[e.name()] = self.skipped.get(e.name(), 0) + 1
                continue
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if name in ranges:
                spans.append((start, start + dur, name))
            if kind == 'launch':
                launches[e.correlation_id()] = start
            host.append((start, start + dur, name))
        self.device = []   # (name, start_ns, end_ns, launch_ns or None)
        for e in device:
            start = e.start_ns()
            self.device.append((e.name(), start, start + e.duration_ns(),
                                launches.get(e.correlation_id())))
        self.device.sort(key=lambda d: d[1])
        spans.sort()
        self._spans = spans
        self._span_starts = [s[0] for s in spans]
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        self.range_names = tuple(ranges)

    # ------------------------------------------------------------ device
    def busy_intervals(self):
        merged = []
        for _, a, b, _ in self.device:
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, match=None):
        """Seconds of the device events whose name ``match`` accepts (all
        without one)."""
        return sum(b - a for n, a, b, _ in self.device
                   if match is None or match(n)) / 1e9

    def count(self, match):
        return sum(1 for n, *_ in self.device if match(n))

    def by_name(self):
        out = {}
        for n, a, b, _ in self.device:
            out[n] = out.get(n, 0.0) + (b - a) / 1e9
        return out

    def range_of(self, launch_ns):
        """The named range whose host span holds ``launch_ns``, or None."""
        if launch_ns is None:
            return None
        i = bisect.bisect_right(self._span_starts, launch_ns) - 1
        while i >= 0:
            a, b, name = self._spans[i]
            if a <= launch_ns <= b:
                return name
            if launch_ns - a > 60e9:
                break
            i -= 1
        return None

    def range_seconds(self):
        """Device seconds of the events launched inside each named range
        (``range_names``), and under 'outside'."""
        out = {name: 0.0 for name in self.range_names}
        out['outside'] = 0.0
        for _, a, b, launch in self.device:
            out[self.range_of(launch) or 'outside'] += (b - a) / 1e9
        return out

    def range_count(self, name):
        return sum(1 for s in self._spans if s[2] == name)

    # -------------------------------------------------------------- host
    def host_op_at(self, t_ns):
        """The innermost host op running at ``t_ns`` (the covering op that
        started last; 'python' if none started in the 64 ops before)."""
        i = bisect.bisect_right(self._host_starts, t_ns) - 1
        for j in range(i, max(i - 64, -1), -1):
            a, b, name = self._host[j]
            if a <= t_ns < b:
                return name
        return 'python'

    def idle_gaps(self, top=10):
        """The idle time of the device inside the window, summed by what
        the host was doing as each gap began, the largest ``top``."""
        gaps, prev = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.end_ns > prev:
            gaps.append((prev, self.end_ns))
        by_op = {}
        for a, b in gaps:
            op = self.host_op_at(a + 500)
            by_op[op] = by_op.get(op, 0.0) + (b - a) / 1e9
        return sorted(by_op.items(), key=lambda kv: -kv[1])[:top]

    def breakdown(self):
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[n, s] for n, s in ops],
                    idle_gaps=[[n, s] for n, s in self.idle_gaps()])


@contextmanager
def traced(ranges=(), cuda=True):
    """Profile the block (host and, with ``cuda``, device); yields a
    holder whose ``trace`` is the :class:`Trace` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        trace = None

    holder = Holder()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        start = time.time_ns()
        yield holder
        sync()
        end = time.time_ns()
    holder.trace = Trace(prof, start, end, ranges)
