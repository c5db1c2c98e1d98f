"""render_device_ms.view: device milliseconds of every kernel, copy and
set a frame launches (march, compaction, packing, decode, composite and
the torch glue between them), from the profiler's trace.  Moves
``view_p95_ms``."""


def read(r):
    if r.trace is None or not r.result['frames']:
        return None
    return r.trace.device_seconds() * 1e3 / r.result['frames']
