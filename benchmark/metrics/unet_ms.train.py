"""unet_ms.train: device milliseconds an iteration spends in work launched
inside the model's ``train_step.diffusion`` range (the UNet's forward and
backward, the diffusion loss and the diffusion Adam step), from the
profiler's trace.  Moves ``train_step_ms``."""


def read(r):
    if r.trace is None or not r.result['iterations']:
        return None
    if not r.trace.range_count('train_step.diffusion'):
        return None
    seconds = r.trace.range_seconds()['train_step.diffusion']
    return seconds * 1e3 / r.result['iterations'] if seconds > 0 else None
