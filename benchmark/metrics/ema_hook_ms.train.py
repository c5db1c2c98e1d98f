"""ema_hook_ms.train: milliseconds an iteration spends in the runner's
``EMAHook`` (``runner/hooks.py``), from ``Runner.timing['hook_s']``: the
runner's ``SpanClock`` CUDA-event spans of each hook.  Moves
``train_step_ms``."""


def read(r):
    seconds = r.result['timing']['hook_s'].get('EMAHook')
    if seconds is None or not r.result['iterations']:
        return None
    return seconds * 1e3 / r.result['iterations']
