"""Discovery of cells, configurations, entries and metrics from files, and
the configuration files against the configs they were resolved from."""
import json

import pytest

from benchmark.harness import cells

SPEC = cells.benchmark_spec()


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files(cell):
    w = cells.workload(cell)
    entry = cells.entry(w['entry'])
    for fn in ('setup', 'window', 'check'):
        assert callable(getattr(entry, fn))
    row = next(x for x in SPEC['workloads'] if x['name'] == cell)
    assert (row['config'], row['chips'], row['why']) == (
        w['config'], w['chips'], w['why'])
    assert row["traffic"] in (w["entry"], cell.split(".", 1)[1])
    assert set(w['limits']) >= {'density_flips'}


@pytest.mark.parametrize('metric', [m['name'] for m in SPEC['per_layer']])
def test_metric_files(metric):
    reader = cells.metric(metric)
    assert callable(reader.read)
    m = next(x for x in SPEC['per_layer'] if x['name'] == metric)
    assert m['moves'] in [e['name'] for e in SPEC['end_to_end']]
    for cell in m['workloads']:
        assert m['moves'] in [e['name'] for e in
                              cells.reported_e2e(SPEC, cell)]


def test_reported_follow_the_spec():
    for w in SPEC['workloads']:
        e2e = [m['name'] for m in cells.reported_e2e(SPEC, w['name'])]
        assert 'setup_s' in e2e and len(e2e) >= 2
        layer = [m['name'] for m in cells.reported(SPEC, w['name'],
                                                   'per_layer')]
        kind = cells.workload(w['name'])['entry']
        assert layer and all(m.endswith('.' + kind) for m in layer)


def test_an_unlisted_metric_is_not_reported():
    spec = json.loads(json.dumps(SPEC))
    spec['per_layer'].append(dict(name='extra.view', unit='ms',
                                  better='lower', source='device_trace',
                                  layer='renderer', moves='view_p95_ms'))
    names = [m['name'] for m in cells.reported(spec, 'cars_uncond.view',
                                                'per_layer')]
    assert 'extra.view' in names
    names = [m['name'] for m in cells.reported(spec, 'cars_uncond.train',
                                                'per_layer')]
    assert 'extra.view' not in names


@pytest.mark.parametrize('config', sorted(
    p.stem for p in (cells.BENCH / 'configs').glob('*.json')))
def test_config_file_is_the_config_as_run(config):
    """Each configuration file, those kept for later cells too."""
    from ssdnerf_torch.config import Config
    spec = cells.config(config)
    for row in SPEC['configs']:
        if row['name'] == config:
            assert row['file'] == f'benchmark/configs/{config}.json'
    resolved = json.loads(json.dumps(Config.fromfile(
        str(cells.ROOT / spec['config_file']))))
    for key in ('model', 'train_cfg', 'test_cfg', 'optimizer', 'lr_config',
                'custom_hooks', 'total_iters'):
        assert spec[key] == resolved[key], key


def test_seeds_take_any_whole_number():
    big = 2 ** 40 + 12345
    assert cells.derive_seed(big, 'a') == cells.derive_seed(big, 'a')
    assert cells.derive_seed(big, 'a') != cells.derive_seed(big + 1, 'a')
    assert 0 <= cells.derive_seed(big, 'b', 3) < 2 ** 63
