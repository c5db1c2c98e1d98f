"""Build and load the port's CUDA kernels.

The sources in ``ssdnerf_torch/csrc/*.cu`` have a plain C interface.  On
first use each is compiled by its own ``nvcc``, all started together, and
the objects are linked into one shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loaded with ``ctypes``.  The library's file name carries a hash of the
sources and their headers (``csrc/*.cuh``), so an edited source is never
served by a stale build.
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
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'march_occupancy': [_P, _P, _P, _I, _I, _I, _P],
    'march_popcount': [_P, _P, _P, _I, _I, _I, _I, _P],
    'triplane_decode': [_P] * 7 + [_I] * 7 + [_P],
    'triplane_decode_bwd': [_P] * 10 + [_I] * 7 + [_P],
    'triplane_decode_composite': [_P] * 12 + [_I] * 8 + [_F] * 3 + [_P],
    'triplane_decode_banded': [_P] * 8 + [_I] * 9 + [_P],
    'attention_fwd': [_P] * 5 + [_I, _I, _I, _F, _P],
    'attention_bwd': [_P] * 10 + [_I, _I, _I, _F, _P],
    'attention_fwd_bf16': [_P] * 6 + [_I, _I, _I, _F, _P],
    'attention_bwd_bf16': [_P] * 10 + [_I, _I, _I, _F, _P],
    'attention_smem_bytes': [_I, _I, _I, _P],
    'attention_fwd_bf16_sm90': [_P] * 6 + [_I, _I, _I, _F, _P],
    'attention_bwd_bf16_sm90': [_P] * 9 + [_I, _I, _I, _F, _P],
    'attention_fwd_bf16_sm90_supported': [_I, _I],
    'attention_bwd_bf16_sm90_supported': [_I, _I],
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
    hashed = srcs + sorted(CSRC.glob('*.cuh'))
    digest = hashlib.sha256(b''.join(p.read_bytes() for p in hashed)
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f'libssdnerf_kernels_{digest}.so'
    log_path = lib.with_suffix('.log')
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
    objs = [tmp.with_name(f'{tmp.name}.{src.stem}.o') for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = ''.join(logs)
    failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], '-shared', '-o',
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = ['link'] if link.returncode else []
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f'nvcc failed ({", ".join(failed)}):\n{log}')
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
