"""No module the benchmark or its reference loads is JAX's or the JAX
package's, by top-level name compared whole (the port's name begins with
the JAX package's), and the reference loads nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {'jax', 'jaxlib', 'flax', 'ssdnerf_tpu'}


def _sources():
    return [p for p in BENCH.rglob('*.py') if 'tests' not in p.parts]


def _imported(path):
    """Top-level names and dotted modules of every import in ``path``,
    those inside functions included."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _loaded(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = {n for n in _imported(path) if n.split('.')[0] in BANNED}
        assert not bad, (path, bad)


def test_reference_sources_import_nothing_of_the_port():
    for path in (BENCH / 'reference').rglob('*.py'):
        bad = {n for n in _imported(path) if n.split('.')[0]
               in BANNED | {'ssdnerf_torch'}}
        assert not bad, (path, bad)


def test_reference_loads_nothing_of_the_port_or_jax():
    loaded = _loaded(
        'import sys, json; sys.path.insert(0, "."); '
        'import benchmark.reference.ssd, benchmark.reference.controls; '
        'import benchmark.counts.unet, benchmark.counts.render; '
        'print(json.dumps(sorted(sys.modules)))')
    tops = {m.split('.')[0] for m in loaded}
    assert not tops & (BANNED | {'ssdnerf_torch'})


def test_benchmark_and_the_port_modules_it_uses_load_no_jax():
    modules = sorted({n for p in _sources() for n in _imported(p)
                      if n.split('.')[0] in ('ssdnerf_torch', 'benchmark')})
    metrics = sorted(p.stem for p in (BENCH / 'metrics').glob('*.py'))
    code = ('import sys, json, importlib; sys.path.insert(0, "."); '
            f'[importlib.import_module(m) for m in {modules!r}]; '
            'from benchmark.harness import cells; '
            f'[cells.metric(m) for m in {metrics!r}]; '
            'import benchmark.calibrate, benchmark.faults; '
            'import benchmark.entries.train, benchmark.entries.view, '
            'benchmark.entries.sample; '
            'print(json.dumps(sorted(sys.modules)))')
    loaded = _loaded(code)
    tops = {m.split('.')[0] for m in loaded}
    assert 'ssdnerf_torch' in tops
    assert not tops & BANNED, sorted(tops & BANNED)
