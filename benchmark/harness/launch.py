"""One run of one cell: set-up, the measured window (traced or not), the
check against the reference, and the result line.

An entry module (``entries/<kind>.py``) gives:

- ``RANGES``: the profiler ranges a traced window attributes device time
  to;
- ``setup(ctx) -> state``: builds the program's state from the seed and
  warms up every shape the window uses (counted in ``setup_s``);
- ``window(ctx, state) -> result``: the measured window; ``result`` holds
  ``attempted``, ``failed``, ``e2e`` (end-to-end values by name) and what
  the per-layer readers read;
- ``check(ctx, state, result) -> {name: value}``: frees the program's
  state, runs the reference and returns the compared numbers; each must
  be at most its limit in the cell's ``limits``.
"""
import datetime
import json
import math
import os
import sys
import time
import types

from . import cells

BANNED = ('jax', 'jaxlib', 'flax', 'ssdnerf_tpu')


def loaded_banned():
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in BANNED)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


class Reading:
    """What a per-layer metric's reader gets: the run's context, the
    window's result and its trace (None in an untraced run)."""

    def __init__(self, ctx, result, trace):
        self.ctx = ctx
        self.result = result
        self.trace = trace
        self.cell = ctx.cell['name']


def run(args, t0):
    spec = cells.benchmark_spec()
    cell = cells.workload(args.workload)
    import torch
    chips = int(cell['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f'error: the cell needs {chips} CUDA device(s); found '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    if chips > 1:
        shm = _shm_files()
        out = in_ranks(_run_rank, chips, 'cuda', t0, spec, cell, vars(args))
        rc, line = out if isinstance(out, tuple) else (out, None)
        left = sorted(_shm_files() - shm)
        if left:
            log(f'error: the ranks left files in /dev/shm: {left}')
            return 5
        return emit(rc, line)
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(4)
    return emit(*run_cell(spec, cell, args, t0, device))


def emit(rc, line):
    """Print the result ``line`` of a run whose code ``rc`` is 0: each
    compared number beside its limit as the last lines of standard error,
    the line as the last of standard output.  Returns ``rc``."""
    if rc != 0 or line is None:
        return rc or 1
    for k, c in line['checks'].items():
        v, limit = c['value'], c['limit']
        log(f'check {k}: {v!r} (limit {limit!r})'
            f'{"" if math.isfinite(v) and v <= limit else " FAILED"}')
    print(json.dumps(line), flush=True)
    return 0


def _shm_files():
    try:
        return set(os.listdir('/dev/shm'))
    except OSError:
        return set()


# ------------------------------------------------------ several chips
RANK_TIMEOUT = datetime.timedelta(seconds=150)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_entry(fn, port, rank, world, device_type, args, t0=None):
    """One rank: join the run's process group (NCCL on cards, gloo on the
    CPU) through the port's ``init_distributed``, then ``fn(group, device,
    *args)``."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    from ssdnerf_torch.parallel.sharding import init_distributed, shutdown
    cuda = device_type == 'cuda'
    device = torch.device('cuda', rank) if cuda else torch.device('cpu')
    if cuda:
        torch.cuda.set_device(device)
    torch.set_num_threads(4 if cuda else 1)
    group = init_distributed(device, 'nccl' if cuda else 'gloo', rank, world,
                             init_method=f'tcp://localhost:{port}',
                             timeout=RANK_TIMEOUT)
    try:
        return fn(group, device, t0, *args)
    finally:
        shutdown()


def _child(fn, port, rank, world, device_type, args):
    sys.exit(_rank_entry(fn, port, rank, world, device_type, args) or 0)


def in_ranks(fn, world, device_type, t0, *args):
    """``fn(group, device, t0, *args)`` in ``world`` processes, one a
    device: rank 0 in this process (``t0`` its start), the others spawned
    and waited for.  NCCL moves data over NVLink and the network stack,
    never through ``/dev/shm``.  ``fn`` returns an exit code on ranks
    other than 0.  Returns rank 0's result (4 where a rank failed)."""
    import multiprocessing as mp
    os.environ['NCCL_SHM_DISABLE'] = '1'
    port = _free_port()
    spawn = mp.get_context('spawn')
    procs = [spawn.Process(target=_child, args=(fn, port, r, world,
                                                device_type, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = _rank_entry(fn, port, 0, world, device_type, args, t0)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        log(f'error: ranks exited {[p.exitcode for p in procs]}')
        return 4
    return out


def _run_rank(group, device, t0, spec, cell, args):
    """``run_cell`` on one rank: rank 0's ``(code, line)``, the others'
    exit code."""
    rc, line = run_cell(spec, cell, types.SimpleNamespace(**args), t0,
                        device, group)
    return (rc, line) if group.rank == 0 else rc


def gather(group, value):
    """Every rank's ``value``, in rank order (itself without a group)."""
    if group is None:
        return [value]
    import torch.distributed as dist
    out = [None] * group.world_size
    dist.all_gather_object(out, value)
    return out


def run_cell(spec, cell, args, t0, device, group=None):
    """Everything of a run after the look for the devices: set-up, window,
    check.  Returns the exit code and the result line (rank 0's, for the
    ranks of ``group``; None on the others and where the run failed)."""
    import torch
    cuda = device.type == 'cuda'
    chips = int(cell['chips'])
    ctx = cells.Context(cell, args.seed, args.seconds, args.trace, device,
                        group)
    entry = cells.entry(cell['entry'])
    state = entry.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    if ctx.rank == 0:
        log(f'setup_s {setup_s:.4f}')
    trace = None
    if ctx.trace:
        from .trace import traced
        with traced(entry.RANGES, cuda) as holder:
            result = entry.window(ctx, state)
        trace = holder.trace
        launched = sum(1 for d in trace.device if d[3] is not None)
        log(f'trace (rank {ctx.rank}): {len(trace.device)} device events, '
            f'{launched} tied to a launch; device seconds by range '
            f'{trace.range_seconds()}; busy {trace.busy_s:.4f} of '
            f'{trace.window_s:.4f} s; left out (ranges on the device) '
            f'{sorted(trace.skipped.items(), key=lambda kv: -kv[1])[:8]}')
    else:
        result = entry.window(ctx, state)
    peak = max(gather(group, torch.cuda.max_memory_allocated(device)
                       if cuda else 0))
    checks = {}
    for rank_checks in gather(group, entry.check(ctx, state, result)):
        for k, v in rank_checks.items():
            v = v if math.isfinite(v) else math.inf
            checks[k] = max(checks.get(k, v), v)
    busy = gather(group, None if trace is None else trace.busy_s)
    # every rank's process, once its window has closed
    banned = set().union(*gather(group, loaded_banned()))
    if group is not None and group.rank != 0:
        return 0, None
    limits = ctx.limits
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in checks.items())
    metrics = {}
    if ctx.trace:
        reading = Reading(ctx, result, trace)
        for m in cells.reported(spec, cell['name'], 'per_layer'):
            value = cells.metric(m['name']).read(reading)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
    else:
        for m in cells.reported_e2e(spec, cell['name']):
            value = setup_s if m['name'] == 'setup_s' \
                else result['e2e'][m['name']]
            metrics[m['name']] = dict(value=value, unit=m['unit'])
        correct = correct and all(math.isfinite(v['value']) and v['value'] > 0
                                  for v in metrics.values())
    dev = dict(platform='gpu' if cuda else 'cpu',
               kind=torch.cuda.get_device_name(0) if cuda else 'cpu',
               count=chips, memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=int(result['attempted']),
                failed=int(result['failed']), metrics=metrics, device=dev)
    if trace is not None:
        dev['busy_s'] = sum(busy) / len(busy)
        dev['window_s'] = trace.window_s
        line['breakdown'] = trace.breakdown()
    bad = sorted(banned | set(loaded_banned()))
    if bad:
        log(f'error: modules of JAX or the JAX package are loaded: {bad}')
        return 3, None
    line['checks'] = {k: dict(value=v, limit=limits[k])
                      for k, v in checks.items()}
    return 0, line
