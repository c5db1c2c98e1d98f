"""The data-parallel cell rehearsed on the CPU: four gloo ranks of the
tiny training cell, each checked against the reference with its own
collectives, the ranks' weights compared; the exchange between chips
left out in the program comes out not correct; a run where a rank other
than the one that prints holds a JAX module prints no result; and
``launch.run`` withholds the result where the ranks leave a file in
``/dev/shm``."""
import contextlib
import io
import json
import sys
import time
import types

import pytest

from benchmark.harness import cells, launch
from benchmark.tests import tiny

SPEC = cells.benchmark_spec()
CELL = 'cars_uncond.train_dp4'


def _skip_exchange():
    """The port's collectives without the exchange: each rank keeps its
    own values.  Returns the original, to put back (rank 0 runs in this
    process)."""
    from ssdnerf_torch.parallel import sharding
    original = sharding.Group._bucket

    def _bucket(self, tensors, op, scale=None):
        out = [torch_as(t, self.device) for t in tensors]
        if op == sharding.dist.ReduceOp.SUM and scale is None:
            out = [t * self.world_size for t in out]
        return out

    sharding.Group._bucket = _bucket
    return original


def torch_as(t, device):
    import torch
    return torch.as_tensor(t, device=device).detach().clone()


def rank_run(group, device, t0, cell, fault, planted=()):
    from ssdnerf_torch.parallel import sharding
    original = _skip_exchange() if fault else None
    sys.modules.update({name: types.ModuleType(name) for name in planted
                        if group.rank == 1})
    try:
        return launch._run_rank(group, device, t0, SPEC, cell,
                                vars(tiny.args()))
    finally:
        if original is not None:
            sharding.Group._bucket = original


def run_ranks(fault=False, planted=()):
    """(exit code, standard output) of the tiny cell on four gloo ranks."""
    cell = tiny.tiny_cell(CELL)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = launch.in_ranks(rank_run, cell['chips'], 'cpu',
                              time.perf_counter(), cell, fault, planted)
        rc = launch.emit(*res) if isinstance(res, tuple) else res
    return rc, out.getvalue()


def run_line(fault=False):
    rc, out = run_ranks(fault)
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


def test_four_ranks_match_the_reference():
    line = run_line()
    assert line['correct'] is True, line['checks']
    assert line['checks']['replica_mismatch']['value'] == 0
    assert line['device']['count'] == 4
    assert list(line)[-1] == 'checks'


def test_exchange_left_out_is_not_correct():
    line = run_line(fault=True)
    assert line['correct'] is False, line['checks']


def test_a_banned_module_on_another_rank_withholds_the_result():
    rc, out = run_ranks(planted=('jax',))
    assert rc == 3 and '"correct"' not in out


@pytest.mark.parametrize('leftover', [False, True])
def test_run_on_four_ranks(monkeypatch, leftover):
    """``launch.run`` of the four-chip cell, its ranks on the CPU: the
    result line, or with a file left in ``/dev/shm`` exit 5 and none."""
    import torch
    cell = tiny.tiny_cell(CELL)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(launch.cells, 'workload', lambda name: cell)
    real = launch.in_ranks
    monkeypatch.setattr(launch, 'in_ranks', lambda fn, world, _, t0, *a:
                        real(fn, world, 'cpu', t0, *a))
    seen = iter([set(), {'left'} if leftover else set()])
    monkeypatch.setattr(launch, '_shm_files', lambda: next(seen))
    args = tiny.args()
    args.workload = CELL
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch.run(args, time.perf_counter())
    if leftover:
        assert rc == 5 and '"correct"' not in out.getvalue()
    else:
        assert rc == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert line['correct'] is True and line['device']['count'] == 4
