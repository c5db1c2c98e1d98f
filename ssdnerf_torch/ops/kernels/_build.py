"""Build and load the port's CUDA kernels.

The sources in ``ssdnerf_torch/csrc/*.cu`` have a plain C interface.  On
first use they are compiled with ``nvcc`` into one shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loaded with ``ctypes``.  The library's file name carries a hash of the
sources, so an edited source is never served by a stale build.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'march_occupancy': [_P, _P, _P, _I, _I, _I, _P],
    'triplane_decode': [_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    'triplane_decode_bwd': [_P] * 10 + [_I] * 6 + [_P],
    'attention_fwd': [_P] * 5 + [_I, _I, _I, ctypes.c_float, _P],
    'attention_bwd': [_P] * 10 + [_I, _I, _I, ctypes.c_float, _P],
}


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(home) / 'bin' / 'nvcc'
    if not path.exists():
        raise RuntimeError(f'nvcc not found at {path}; the CUDA kernels '
                           'need the CUDA toolkit')
    return str(path)


def _sources():
    return sorted(CSRC.glob('*.cu'))


@functools.lru_cache(maxsize=None)
def build_info():
    """Compile the kernels if needed; returns (library path, seconds spent
    compiling (0.0 when a current build existed), compiler log)."""
    srcs = _sources()
    digest = hashlib.sha256(b''.join(p.read_bytes() for p in srcs)
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f'libssdnerf_kernels_{digest}.so'
    log_path = lib.with_suffix('.log')
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, with every function's argtypes set."""
    lib = ctypes.CDLL(str(build_info()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name, device, *args):
    """Call kernel entry ``name`` on ``device``'s current stream; raise on a
    launch error (a refused launch never runs, and a later synchronize
    would not report it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} on {device}')


def check_cuda(name, *tensors, dtype=None):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (and of ``dtype`` when given)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f'{name}: needs contiguous tensors on one '
                             f'device, got {t.device} contiguous='
                             f'{t.is_contiguous()}')
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f'{name}: needs {dtype}, got {t.dtype}')
