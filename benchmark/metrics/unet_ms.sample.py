"""unet_ms.sample: device milliseconds of one UNet forward of the
sampler's chain: the work launched inside the benchmark's
``benchmark.unet`` ranges (forward hooks on the EMA UNet open and close
them in a traced run), from the profiler's trace, over the forwards.
Moves ``sample_scenes_per_s``."""


def read(r):
    if r.trace is None:
        return None
    calls = r.trace.range_count('benchmark.unet')
    if not calls:
        return None
    seconds = r.trace.range_seconds()['benchmark.unet']
    return seconds * 1e3 / calls if seconds > 0 else None
