"""Where the decode kernels' time goes, on the card, without a profiler.

``ncu`` and ``nsys`` may be unavailable where the card is; this tool takes
their place for ``csrc/decode.cu``:

* SASS counts: ``cuobjdump -sass`` of a build, and for each instance of
  the decode kernels the instructions of every innermost loop (a backward
  branch and the code it jumps back over) and of the whole function, by
  class: shared loads (``LDS``), f32 FMAs (``FFMA``), tensor-core
  products (``HMMA``), global reductions and atomics (``RED``/``ATOM``),
  global loads (``LDG``);
* ``ptxas -v``: registers, spills and shared memory of each kernel;
* one-line variants: ``decode.cu`` copied under ``build/variants/`` with
  one part of the backward cut out (the plane-gradient scatter, the MLP
  products, both), each built alone and timed beside the unchanged source
  at the training shape (8 scenes x 4096 rays x 64 samples along each ray,
  1/74 of the box apart), so that the differences split the backward's
  time.  The variants compute wrong gradients: they exist only here.

    python -m ssdnerf_torch.tools.decode_profile [--csrc DIR] [--out FILE]

``--csrc`` names another copy of the sources (a parent commit unpacked
under ``build/``, say); the result is one JSON object, printed and written
to ``--out``.  It also holds the forward's time at the training shape and
on 8 x 64^3 points of a density-only decode (uniform random, and in the
density-grid update's order), and, for the package's
own sources, the kernels' errors against the plain version in f32 and
f64.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import _build

KERNELS = ('triplane_decode_kernel', 'triplane_decode_bwd_kernel')
RAGGED = dict(S=2, n_rays=25, K=40)   # 1000 samples a scene: a partial tile
CLASSES = {'LDS': r'LDS', 'FFMA': r'FFMA', 'HMMA': r'HMMA',
           'RED/ATOM': r'(RED|ATOM)G?', 'LDG': r'LDG'}

# Each variant: alternative edit lists, one for each version of decode.cu
# (the FMA kernels, then the tensor-core kernels that replaced them);
# the first list whose old texts are all in the source applies, and a
# variant none of whose lists applies is reported as not applicable.  The
# stand-ins keep their inputs alive (a store that never runs, a bit
# operation in place of the mma), so that the compiler does not remove the
# work before them.
_KEEP_DFEAT = ('{ float k_ = 0.0f; for (int f = 0; f < F; ++f) k_ += '
               'dfeat[f]; if (k_ == 1.2345e-30f) dplanes_s[0] = k_; }')
_KEEP_DF = ('{ float k_ = 0.0f; for (int f = 0; f < FP; ++f) k_ += df[f]; '
            'if (k_ == 1.2345e-30f) d_planes[0] = k_; }')
_NO_MMA = 'acc[0][0][0] += __uint_as_float(ah[0][0] & fh[0][0][0]);'
VARIANTS = {
    'no_scatter': [
        [('scatter_features<C>(dplanes_s, x, y, z, res, dfeat);',
          _KEEP_DFEAT)],
        [('scatter_features<C>(d_planes + s * plane_size, x, y, z, res, '
          'df);', _KEEP_DF)]],
    'no_products': [
        [('for (int f = 0; f < F; ++f) a += wb[hh * F + f] * feat[f];',
          'a += feat[0];'),
         ('for (int f = 0; f < F; ++f) acc[f] += db * sF[t * FS + f];',
          'acc[0] += db;'),
         ('for (int f = 0; f < F; ++f) dfeat[f] += wb[hh * F + f] * d;',
          'dfeat[0] += d;')],
        [('mma3_batch<2, NTW>(acc, ah, al, fh, fl);', _NO_MMA),
         ('mma3_batch<2, KF>(acc, ah, al, fh, fl);', _NO_MMA)]],
}
VARIANTS['neither'] = [a + b for a, b in zip(VARIANTS['no_scatter'],
                                             VARIANTS['no_products'])]
# the plane-gradient scatter by float2 atomics alone (36 a sample at C = 6,
# as the FMA kernels did) in place of float4 + float2 (24)
VARIANTS['float2_atomics'] = [[(
    '''    atomicAdd(reinterpret_cast<float4*>(p + c),
              make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));''',
    '''    add2(c);
    add2(c + 2);''')]]


def _tool(name):
    return str(Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))
               / 'bin' / name)


def sass_counts(lib):
    """:func:`parse_sass` of ``cuobjdump -sass`` of shared library
    ``lib``."""
    return parse_sass(subprocess.run(
        [_tool('cuobjdump'), '-sass', str(lib)], capture_output=True,
        text=True, check=True).stdout)


def parse_sass(text):
    """{function name: {'whole': counts, 'loops': [counts, ...]}} for the
    decode kernels of a SASS listing; counts by CLASSES plus the
    instruction total, for each innermost loop [first, last address]."""
    out = {}
    for body in text.split('Function : ')[1:]:
        name = body.split('\n', 1)[0].strip()
        if not any(k in name for k in KERNELS):
            continue
        inst = [(int(a, 16), op) for a, op in re.findall(
            r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', body)]
        loops = []
        for addr, op in inst:
            m = re.search(r'BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)', op)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        # innermost: no other loop nested inside
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]

        def count(lo, hi):
            ops = [op for a, op in inst if lo <= a <= hi]
            c = {k: sum(bool(re.search(r'(^|\s)' + p + r'\b', o))
                        for o in ops) for k, p in CLASSES.items()}
            c['total'] = len(ops)
            return c

        out[name] = dict(whole=count(0, 1 << 62), loops=[
            dict(range=f'{lo:#x}-{hi:#x}', **count(lo, hi))
            for lo, hi in sorted(inner)])
    return out


def _build_one(src_dir, name, edits):
    """decode.cu of ``src_dir`` with ``edits`` applied, built alone into
    build/variants/<name>/; returns (library path, ptxas log) or None when
    an edit does not apply."""
    out = _build.BUILD_DIR.parent / 'variants' / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in Path(src_dir).glob('*.cuh'):
        shutil.copy(f, out)
    code = (Path(src_dir) / 'decode.cu').read_text()
    if edits:
        edits = next((e for e in edits if all(o in code for o, _ in e)),
                     None)
        if edits is None:
            return None
        for old, new in edits:
            code = code.replace(old, new)
    (out / 'decode.cu').write_text(code)
    lib = out / 'libdecode.so'
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', str(lib), str(out / 'decode.cu')],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed for variant {name}:\n'
                           f'{proc.stdout}{proc.stderr}')
    return lib, proc.stdout + proc.stderr


def training_inputs(device, seed=0, S=8, n_rays=4096, K=64):
    """The decode's operands at the training shape: chip_smoke.py's
    per-ray layout (S=8 scenes x 4096 rays x K=64 samples 1/74 of the box
    apart along each ray), C=6, hidden 64, with upstream gradients."""
    g = torch.Generator().manual_seed(seed)
    C, res, hidden = 6, 128, 64
    planes = torch.randn((S, 3, res, res, C), generator=g)
    params = torch.randn(hidden * 3 * C + 5 * hidden + 4, generator=g) * 0.2
    start = torch.rand((S, n_rays, 1, 3), generator=g) * 2 - 1
    step = torch.nn.functional.normalize(
        torch.randn((S, n_rays, 1, 3), generator=g), dim=-1) * (2 / 148)
    xyz = (start + step * torch.arange(K)[:, None]).clamp(-1, 1)
    xyz = xyz.reshape(S, n_rays * K, 3)
    rid = torch.arange(n_rays, dtype=torch.int32).repeat_interleave(
        K).expand(S, -1)
    dir_out = torch.randn((S, n_rays, hidden), generator=g) * 0.3
    g_sigma = torch.randn((S, n_rays * K), generator=g)
    g_rgb = torch.randn((S, n_rays * K, 3), generator=g)
    t = [x.contiguous().to(device) for x in
         (planes, xyz, rid, dir_out, params, g_sigma, g_rgb)]
    return dict(zip(('planes', 'xyz', 'rid', 'dir_out', 'params', 'g_sigma',
                     'g_rgb'), t), S=S, M=n_rays * K, n_rays=n_rays, res=res,
                C=C, hidden=hidden)


def _device_ms(call, reps=5, calls=20):
    """Median device ms of one call (CUDA events around ``calls`` calls,
    ``reps`` times, after 2 warm-ups)."""
    for _ in range(2):
        call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _entry(lib, name):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'{name}: CUDA error {err}')
    return call


def time_backward(lib, inp):
    """Device ms of one backward call of library ``lib`` on ``inp``."""
    fn = _entry(lib, 'triplane_decode_bwd')
    outs = [torch.zeros_like(inp[k]) for k in ('planes', 'dir_out',
                                                'params')]
    args = [inp[k].data_ptr() for k in ('planes', 'xyz', 'rid', 'dir_out',
                                        'params', 'g_sigma', 'g_rgb')]
    args += [t.data_ptr() for t in outs]
    args += [inp[k] for k in ('S', 'M', 'n_rays', 'res', 'C', 'hidden')]
    return _device_ms(lambda: fn(*args))


def time_forward(lib, inp, colour=True):
    """Device ms of one forward call of library ``lib`` on ``inp`` (colour
    or density-only)."""
    fn = _entry(lib, 'triplane_decode')
    S, M = inp['S'], inp['M']
    sigma = torch.empty((S, M), device=inp['xyz'].device)
    rgb = torch.empty((S, M, 3), device=inp['xyz'].device)
    ptr = [inp[k].data_ptr() if colour else None for k in ('rid', 'dir_out')]
    args = [inp['planes'].data_ptr(), inp['xyz'].data_ptr(), *ptr,
            inp['params'].data_ptr(), sigma.data_ptr(),
            rgb.data_ptr() if colour else None]
    args += [inp[k] for k in ('S', 'M', 'n_rays', 'res', 'C', 'hidden')]
    return _device_ms(lambda: fn(*args))


def density_inputs(inp, grid=64, seed=1, ordered=False):
    """``inp`` with S x grid^3 points of a density-only decode: uniform
    random points (chip_smoke.py's row), or ``ordered``, the voxel centres
    in the linear order of the density-grid update
    (models/decoders/renderer.py) plus a jitter within the voxel."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((inp['S'], grid ** 3, 3), generator=g) * 2 - 1
    if ordered:
        lin = torch.arange(grid ** 3)
        ijk = torch.stack([lin // grid ** 2, (lin // grid) % grid,
                           lin % grid], -1)
        u = ((ijk + 0.5 + 0.5 * u) * (2.0 / grid) - 1).clamp(-1, 1)
    return dict(inp, xyz=u.contiguous().to(inp['xyz'].device),
                M=grid ** 3)


def precision(inp):
    """Max errors of the port's decode kernels (the current build, through
    the wrappers of ops/kernels/decode.py) against the plain version in
    f32 and in f64, at the training shape: the forward's max |error|; the
    backward's max |error| / max |reference| for each gradient."""
    from ..ops.kernels import decode as k_dec
    args = [inp[k] for k in ('planes', 'xyz', 'params')]
    h, rid, d, g = inp['hidden'], inp['rid'], inp['dir_out'], (
        inp['g_sigma'], inp['g_rgb'])
    f64 = [a.double() for a in args]
    fwd = k_dec.triplane_decode(*args, h, rid, d)
    bwd = k_dec.triplane_decode_backward(*args, h, rid, d, *g)
    out = {}
    for tag, cast in (('f32', lambda t: t), ('f64', lambda t: t.double())):
        ref = k_dec.triplane_decode_plain(*[cast(a) for a in args], h, rid,
                                          cast(d))
        out[f'forward_vs_{tag}'] = max(
            (a.double() - b.double()).abs().max().item()
            for a, b in zip(fwd, ref))
        ref = k_dec.triplane_decode_backward_plain(
            *[cast(a) for a in args], h, rid, cast(d), *map(cast, g))
        out[f'backward_vs_{tag}'] = {
            n: ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()
            for n, a, b in zip(('planes', 'params', 'dir_out'), bwd, ref)}
    return out


def ptxas_lines(log):
    """The ptxas lines of the decode kernels (usage follows the line that
    names the function)."""
    lines, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line or 'Function properties' in line:
            keep = any(k in line for k in KERNELS)
        if keep and ('registers' in line or 'spill' in line
                     or 'Compiling' in line):
            lines.append(line.strip())
    return lines


def run(csrc, rounds=2):
    """SASS counts and ptxas lines of ``csrc``'s decode.cu, the
    backward's time with each variant, in turns (base, variants...,
    repeated ``rounds`` times), and, when ``csrc`` is the package's own
    sources, the kernels' errors (:func:`precision`)."""
    names = ['base'] + list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build_one(csrc, n, [] if n == 'base'
                                 else VARIANTS[n]), names)))
    inp = training_inputs('cuda')
    dens = density_inputs(inp)
    grid = density_inputs(inp, ordered=True)
    times = {n: [] for n, b in built.items() if b is not None}
    fwd = {'per_ray': [], 'density_only': [], 'density_grid_order': []}
    for _ in range(rounds):
        for n in times:
            times[n].append(time_backward(built[n][0], inp))
        fwd['per_ray'].append(time_forward(built['base'][0], inp))
        fwd['density_only'].append(time_forward(built['base'][0], dens,
                                                colour=False))
        fwd['density_grid_order'].append(
            time_forward(built['base'][0], grid, colour=False))
    base_lib, base_log = built['base']
    same = Path(csrc).resolve() == _build.CSRC.resolve()
    return dict(
        device=torch.cuda.get_device_name(0), csrc=str(csrc),
        precision=dict(
            training=precision(inp),
            ragged=precision(training_inputs('cuda', **RAGGED))) if same
        else None,
        sass=sass_counts(base_lib), ptxas=ptxas_lines(base_log),
        variant_ptxas={n: ptxas_lines(b[1]) for n, b in built.items()
                       if b is not None and n != 'base'},
        not_applicable=[n for n, b in built.items() if b is None],
        backward_ms=times, forward_ms=fwd)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--csrc', default=str(_build.CSRC))
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('decode_profile needs a CUDA card')
    res = run(Path(args.csrc).resolve())
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == '__main__':
    main()
