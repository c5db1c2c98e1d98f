"""render_ms.train: device milliseconds an iteration spends in work
launched inside the model's ``train_step.inverse`` and
``train_step.decoder`` ranges (the inverse-rendering code steps, the
density update, the decoder's render loss and Adam step), from the
profiler's trace.  Moves ``train_step_ms``."""


def read(r):
    if r.trace is None or not r.result['iterations']:
        return None
    if not r.trace.range_count('train_step.inverse'):
        return None
    parts = r.trace.range_seconds()
    seconds = parts['train_step.inverse'] + parts['train_step.decoder']
    return seconds * 1e3 / r.result['iterations'] if seconds > 0 else None
