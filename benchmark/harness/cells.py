"""Discovery by file name, and the context of one run.

- a cell: ``workloads/<cell>.json`` (its config, chips, entry kind, traffic
  parameters, check limits and why);
- a configuration: ``configs/<config>.json`` (the resolved config of the
  port as it is run, its source, reduced keys and assumptions);
- an entry kind: ``entries/<kind>.py``;
- a per-layer metric: ``metrics/<metric>.py`` (a file name may hold dots,
  so metrics load by path);
- which metrics a cell reports: ``BENCHMARK.json`` at the checkout root.
"""
import importlib
import importlib.util
import json
import zlib
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec():
    return read_json(ROOT / 'BENCHMARK.json')


def workload(name):
    """The cell ``name``, with its configuration under ``config_spec``."""
    cell = read_json(BENCH / 'workloads' / f'{name}.json')
    cell['name'] = name
    cell['config_spec'] = config(cell['config'])
    return cell


def config(name):
    spec = read_json(BENCH / 'configs' / f'{name}.json')
    spec['name'] = name
    return spec


def entry(kind):
    return importlib.import_module(f'benchmark.entries.{kind}')


def metric(name):
    """The reader module of per-layer metric ``name``."""
    path = BENCH / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reported(spec, cell_name, kind):
    """Entries of ``spec[kind]`` ('end_to_end' or 'per_layer') that cell
    ``cell_name`` reports: those listing it under ``workloads``, and those
    without the key whose end-to-end metric the cell reports."""
    e2e = [m['name'] for m in reported_e2e(spec, cell_name)]
    if kind == 'end_to_end':
        return reported_e2e(spec, cell_name)
    out = []
    for m in spec['per_layer']:
        cells = m.get('workloads')
        if cells is not None and cell_name in cells:
            out.append(m)
        elif cells is None and m['moves'] in e2e:
            out.append(m)
    return out


def reported_e2e(spec, cell_name):
    return [m for m in spec['end_to_end']
            if cell_name in m.get('workloads', [cell_name])]


def derive_seed(seed, *tags):
    """A 63-bit seed from the run's ``seed`` (any whole number) and
    ``tags`` (strings or whole numbers): the same arguments give the same
    seed."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64]
    for tag in tags:
        words.append(zlib.crc32(tag.encode()) if isinstance(tag, str)
                     else int(tag))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


class Context:
    """One run of one cell: its arguments, cell, configuration and
    device, and the seeds of its inputs."""

    def __init__(self, cell, seed, seconds, trace, device, group=None):
        self.cell = cell
        self.group = group
        self.rank = 0 if group is None else group.rank
        self.world = 1 if group is None else group.world_size
        self.config = cell['config_spec']
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.traffic = cell['traffic']
        self.limits = cell['limits']
        self.notes = {}

    def seed_for(self, *tags):
        return derive_seed(self.seed, *tags)

    def generator(self, *tags, device=None):
        import torch
        dev = self.device if device is None else device
        return torch.Generator(device=dev).manual_seed(self.seed_for(*tags))

    def sync(self):
        """Wait for the device's queued work (nothing to wait for on the
        CPU, where the tests run the entries)."""
        if self.device.type == 'cuda':
            import torch
            torch.cuda.synchronize(self.device)

    def note(self, key, value):
        """A figure the run prints on standard error (rank 0's) and keeps
        in ``notes`` (occupancy, counts, the reference's time)."""
        self.notes[key] = value
        if self.rank == 0:
            import sys
            print(f'note {key}: {value}', file=sys.stderr, flush=True)


def empty_cache(ctx):
    """Give the freed program state's device memory back."""
    import gc
    gc.collect()
    if ctx.device.type == 'cuda':
        import torch
        torch.cuda.empty_cache()
