"""idle_pct.train: the share (%) of the traced window in which no kernel,
copy or set ran on the device, from the profiler's trace.  Moves
``train_step_ms``."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
