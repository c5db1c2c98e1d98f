#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ssdnerf_torch`` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for.  Prints what it measured and checked on standard error and one
JSON object as the last line of standard output (``benchmark/README.md``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout (the
    # port builds its kernels under build/kernels there itself)
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          str(ROOT / 'build' / 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import launch
    return launch.run(args, T0)


if __name__ == '__main__':
    sys.exit(main())
