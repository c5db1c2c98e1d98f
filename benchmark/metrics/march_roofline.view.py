"""march_roofline.view: the march kernel's share (%) of its roofline over
the window: one occupancy lookup a march slot of every frame (the rays
times the march's slots, ``benchmark/counts/march.py``) over the kernel's
device time in the trace.  Moves ``view_p95_ms``."""
from benchmark.counts import march

KERNEL = 'march_occupancy'


def read(r):
    res = r.result
    if r.trace is None or res.get('counts') is None:
        return None
    seconds = r.trace.device_seconds(lambda n: KERNEL in n)
    if seconds <= 0:
        return None
    grid = res['spec']['model']['grid_size']
    work = march.occupancy(res['counts'][1], grid, scenes=res['frames'])
    return 100.0 * work.bound_s() / seconds
