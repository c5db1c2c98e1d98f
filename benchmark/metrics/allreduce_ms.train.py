"""allreduce_ms.train: device milliseconds an iteration spends in NCCL's
kernels (the gradient all-reduces of ``parallel/sharding.py``'s ``Group``
and the reduced statistics), on rank 0, from the profiler's trace.  Moves
``train_step_ms``."""


def read(r):
    if r.trace is None or not r.result['iterations']:
        return None
    seconds = r.trace.device_seconds(lambda n: 'nccl' in n.lower())
    return seconds * 1e3 / r.result['iterations'] if seconds > 0 else None
