"""Each cell's entry run whole on the CPU at a tiny size (``tiny.py``),
the program against the reference, and the keys of the result line."""
import contextlib
import io
import json
import time

import pytest

from benchmark.harness import cells, launch
from benchmark.tests import tiny

SPEC = cells.benchmark_spec()
# every cell with a file, those kept for later cells too
CELLS = sorted(p.stem for p in (cells.BENCH / 'workloads').glob('*.json'))


def run_line(cell, **kw):
    """The last line a run of ``cell`` (a tiny cell) prints, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch.emit(*launch.run_cell(SPEC, cell, tiny.args(**kw),
                                          time.perf_counter(), tiny.CPU))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize('name', CELLS)
def test_entry_matches_the_reference(name):
    line = run_line(tiny.tiny_cell(name))
    assert line['correct'] is True, line['checks']
    assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
    assert list(line)[-1] == 'checks'
    for check in line['checks'].values():
        assert set(check) == {'value', 'limit'}
        assert check['value'] <= check['limit']
    assert line['attempted'] > 0 and line['failed'] == 0
    names = [m['name'] for m in cells.reported_e2e(SPEC, name)]
    assert sorted(line['metrics']) == sorted(names)
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    assert set(line['device']) == {'platform', 'kind', 'count',
                                   'memory_peak_bytes'}


def test_traced_run_reports_per_layer_metrics():
    line = run_line(tiny.tiny_cell('cars_uncond.train'), trace=1)
    assert line['correct'] is True
    assert {'busy_s', 'window_s'} <= set(line['device'])
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    listed = {m['name'] for m in cells.reported(SPEC, 'cars_uncond.train',
                                                'per_layer')}
    assert set(line['metrics']) <= listed
    assert 'ema_hook_ms.train' in line['metrics']
