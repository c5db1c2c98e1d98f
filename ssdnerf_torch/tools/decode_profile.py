"""Where the decode kernels' time goes, on the card, without a profiler.

``ncu`` and ``nsys`` may be unavailable where the card is; this tool takes
their place for the decode kernels (``csrc/decode.cu``,
``csrc/decode_composite.cu``, ``csrc/decode_banded.cu``):

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
f64.  On the packed layouts of ``chip_smoke.py`` phase 2 (a ball seen by 4
look-at views of 128x128 in each of 8 scenes, P = 512) it times the split
forward over every slot, the fused decode + composite and the banded
decode, f32 and bf16, from ``--csrc``'s sources and, where those are
another copy, from the package's own, in turns (``--csrc``'s, the
package's, the package's, ``--csrc``'s), with ptxas's registers and
spills of both builds.
"""
import argparse
import ctypes
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models.decoders.renderer import (GROUP_RAYS, dt_bounds,
                                        march_samples, slot_samples)
from ..models.decoders.triplane import TriPlaneDecoder
from ..ops import get_cam_rays, packbits, t_at_step
from ..ops.kernels import _build
from ..ops.kernels import decode as k_dec
from ..ops.packing import (band_keys_and_payload, banded_windows,
                           pack_groups_banded)

DECODE_SOURCES = ('decode.cu', 'decode_composite.cu', 'decode_banded.cu')
KERNELS = ('triplane_decode_kernel', 'triplane_decode_bwd_kernel',
           'triplane_decode_composite_kernel',
           'triplane_decode_banded_kernel')
RAGGED = dict(S=2, n_rays=25, K=40)   # 1000 samples a scene: a partial tile
CLASSES = {'LDS': r'LDS', 'FFMA': r'FFMA', 'HMMA': r'HMMA',
           'RED/ATOM': r'(RED|ATOM)G?', 'LDG': r'LDG'}

# Each variant: alternative edit lists, one for each version of decode.cu
# (the FMA kernels, the tensor-core kernels that replaced them, then those
# with the bf16 operand mode; a variant times the f32 mode);
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
          'df);', _KEEP_DF)],
        [('scatter_features<C>(d_planes + s * dplane_size, x, y, z, res, '
          'df);', _KEEP_DF)]],
    'no_products': [
        [('for (int f = 0; f < F; ++f) a += wb[hh * F + f] * feat[f];',
          'a += feat[0];'),
         ('for (int f = 0; f < F; ++f) acc[f] += db * sF[t * FS + f];',
          'acc[0] += db;'),
         ('for (int f = 0; f < F; ++f) dfeat[f] += wb[hh * F + f] * d;',
          'dfeat[0] += d;')],
        [('mma3_batch<2, NTW>(acc, ah, al, fh, fl);', _NO_MMA),
         ('mma3_batch<2, KF>(acc, ah, al, fh, fl);', _NO_MMA)],
        [('mma3_batch<2, NTW, kB>(acc, ah, al, fh, fl);', _NO_MMA),
         ('mma3_batch<2, KF, kB>(acc, ah, al, fh, fl);', _NO_MMA)]],
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


def _build_one(src_dir, name, edits, sources=('decode.cu',)):
    """``sources`` of ``src_dir`` (those it has), decode.cu with ``edits``
    applied, each compiled by its own nvcc, all at once, and linked into
    build/variants/<name>/; returns (library path, ptxas log) or None when
    an edit does not apply."""
    out = _build.BUILD_DIR.parent / 'variants' / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in Path(src_dir).glob('*.cuh'):
        shutil.copy(f, out)
    srcs = [s for s in sources if (Path(src_dir) / s).exists()]
    for s in srcs:
        shutil.copy(Path(src_dir) / s, out)
    code = (out / 'decode.cu').read_text()
    if edits:
        edits = next((e for e in edits if all(o in code for o, _ in e)),
                     None)
        if edits is None:
            return None
        for old, new in edits:
            code = code.replace(old, new)
    (out / 'decode.cu').write_text(code)
    lib = out / 'libdecode.so'
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, '-c',
                               '-o', str(out / f'{s}.o'), str(out / s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in srcs]
    log = ''.join(p.communicate()[0] for p in procs)
    if not any(p.returncode for p in procs):
        link = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS[:2], '-shared', '-o',
             str(lib), *(str(out / f'{s}.o') for s in srcs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
    if any(p.returncode for p in procs) or not lib.exists():
        raise RuntimeError(f'nvcc failed for variant {name}:\n{log}')
    return lib, log


def _full_build(src_dir, name):
    """All decode sources of ``src_dir`` in one library."""
    return _build_one(src_dir, name, [], sources=DECODE_SOURCES)


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
    return _device_ms(lambda: fn(*args, 0))     # the f32 mode


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
    return _device_ms(lambda: fn(*args, 0))     # the f32 mode


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


# SRN-cars intrinsics (fx, fy, cx, cy) of a 128x128 view
SRN_INTRINSICS = (131.25, 131.25, 64.0, 64.0)


def look_at_pose(cam_pos):
    """OpenCV-style camera-to-world pose (x right, y down, z forward)
    looking at the origin with +y up, as tests/synthetic.py builds it."""
    cam_pos = np.asarray(cam_pos, np.float32)
    forward = -cam_pos / np.linalg.norm(cam_pos)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0], np.float32))
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = np.cross(forward, right)
    pose[:3, 2] = forward
    pose[:3, 3] = cam_pos
    return pose


def look_at_views(num_scenes, angles_deg, device, radius=2.55,
                  height=0.6):
    """Look-at poses around the origin at ``radius`` (SRN-cars
    intrinsics): (S, V, 4, 4) and (S, V, 4)."""
    a = np.radians(angles_deg)
    poses = np.stack([look_at_pose([radius * math.cos(t), height,
                                    radius * math.sin(t)]) for t in a])
    poses = torch.from_numpy(poses).expand(num_scenes, -1, -1, -1)
    intr = torch.tensor(SRN_INTRINSICS).expand(num_scenes, len(a), 4)
    return poses.contiguous().to(device), intr.contiguous().to(device)


# four views around the ball whose every 128-slot tile of the band layout
# fits its plane windows (the banded guard holds; 135 and 180 degrees it
# does not)
BALL_VIEWS = (45, 90, 225, 270)


def ball_bitfield(num_scenes, grid, device):
    """Occupancy of a ball of radius 0.35 grid (the JAX package's banded
    test scene, tests/test_packing.py:_camera_scene)."""
    c = torch.arange(grid) - grid / 2 + 0.5
    occ = (c[:, None, None] ** 2 + c[None, :, None] ** 2
           + c[None, None, :] ** 2) < (0.35 * grid) ** 2
    return packbits(occ.reshape(1, -1).float().expand(num_scenes, -1)
                    .contiguous(), 0.5).to(device)


def ball_layouts(dec, num_scenes, grid, res, device):
    """The packed layouts of a render of the ball from BALL_VIEWS at
    128x128, as ``volume_render`` builds them for ``banded_decode``: the
    ray layout's slots (positions, ray ids, t, dt, validity, segment
    starts) and the band layout's (positions, ray ids, validity, tile
    windows and the guard)."""
    poses, intr = look_at_views(num_scenes, BALL_VIEWS, device)
    rays_o, rays_d = get_cam_rays(poses, intr, 128, 128)
    rays_o = rays_o.reshape(num_scenes, -1, 3)
    rays_d = rays_d.reshape(num_scenes, -1, 3)
    bitfield = ball_bitfield(num_scenes, grid, device)
    dt_min, dt_max = dt_bounds(dec.max_steps, grid)
    with torch.no_grad():
        t0, dtg, cstep, cvalid = march_samples(dec, rays_o, rays_d,
                                               bitfield, grid)
        ts = t_at_step(t0, cstep, dtg[:, None, None], dt_min, dt_max)
        bandk, payload = band_keys_and_payload(rays_o, rays_d, ts, cvalid,
                                               dec.bound, res)
        ray_l, band_l, _, payload_b = pack_groups_banded(
            cstep, cvalid, bandk, dec.pack_slots, GROUP_RAYS, payload)
        win, ok = banded_windows(payload_b, res, k_dec.BAND_W, k_dec.TILE)
        pstep, pvalid, prid, soffs = ray_l
        pt, pdt, xyz, ray = slot_samples(rays_o, rays_d, t0, dtg, pstep,
                                         prid, dt_min, dt_max, dec.bound)
        _, _, xyz_b, ray_b = slot_samples(rays_o, rays_d, t0, dtg,
                                          band_l[0], band_l[2], dt_min,
                                          dt_max, dec.bound)
    S, G, P = pt.shape
    return dict(rays_d=rays_d, xyz=xyz.reshape(S, G * P, 3).contiguous(),
                rid=ray, pt=pt, pdt=pdt, pvalid=pvalid,
                soffs=soffs.to(torch.int32),
                xyz_b=xyz_b.reshape(S, G * P, 3).contiguous(), rid_b=ray_b,
                pvalid_b=band_l[1], win=win, ok=bool(ok))


def ball_inputs(device, seed=0):
    """The operands of ``chip_smoke.py`` phase 2's ball rows: the layouts
    of :func:`ball_layouts` for 8 scenes at the flagship width (64^3 grid,
    3 x 6 x 128^2 planes, hidden 64, P = 512), seeded random planes, MLP
    block and per-ray dir_out, with the bf16 mode's operands beside."""
    S, grid, C, res, hidden = 8, 64, 6, 128, 64
    dec = TriPlaneDecoder(compact_steps=64, march_slots=128, pack_slots=512)
    lay = ball_layouts(dec, S, grid, res, device)
    g = torch.Generator().manual_seed(seed)
    planes = torch.randn((S, 3, res, res, C), generator=g).to(device)
    params = (torch.randn(hidden * 3 * C + 5 * hidden + 4, generator=g)
              * 0.2).to(device)
    dir_out = (torch.randn((S, lay['rays_d'].shape[1], hidden),
                           generator=g) * 0.3).to(device)
    planes_b, _ = k_dec._kernel_planes(planes.bfloat16())
    params_b = k_dec.round_weights(params, hidden, 3 * C).contiguous()
    return dict(lay, planes=planes, params=params, planes_b=planes_b,
                params_b=params_b, dir_out=dir_out, S=S, res=res, C=C,
                hidden=hidden)


def render_calls(lib, inp):
    """{row: call} of library ``lib``'s split forward over every slot of
    the ray layout, fused decode + composite and banded decode on
    :func:`ball_inputs`, each in f32 and in the bf16 mode."""
    fwd = _entry(lib, 'triplane_decode')
    comp = _entry(lib, 'triplane_decode_composite')
    band = _entry(lib, 'triplane_decode_banded')
    S, G, P = inp['pt'].shape
    M, n_rays = G * P, inp['dir_out'].shape[1]
    dev = inp['pt'].device
    sigma = torch.empty((S, M), device=dev)
    rgb = torch.empty((S, M, 3), device=dev)
    ray = [torch.empty((S, n_rays), device=dev) for _ in range(2)]
    image = torch.empty((S, n_rays, 3), device=dev)
    ptr = lambda *k: [inp[x].data_ptr() for x in k]
    calls = {}
    for mode, bf16 in (('f32', 0), ('bf16', 1)):
        planes, params = ((inp['planes'], inp['params']) if not bf16 else
                          (inp['planes_b'], inp['params_b']))
        common = (inp['res'], inp['C'], inp['hidden'])
        calls[f'forward_{mode}'] = functools.partial(
            fwd, planes.data_ptr(), *ptr('xyz', 'rid', 'dir_out'),
            params.data_ptr(), sigma.data_ptr(), rgb.data_ptr(), S, M,
            n_rays, *common, bf16)
        calls[f'composite_{mode}'] = functools.partial(
            comp, planes.data_ptr(), *ptr('xyz', 'rid', 'dir_out'),
            params.data_ptr(), *ptr('pt', 'pdt', 'pvalid', 'soffs'),
            ray[0].data_ptr(), ray[1].data_ptr(), image.data_ptr(), S, G, P,
            GROUP_RAYS, *common, bf16, 1.002, 0.001, 1e-4)
        calls[f'banded_{mode}'] = functools.partial(
            band, planes.data_ptr(), *ptr('xyz_b', 'rid_b', 'dir_out'),
            params.data_ptr(), inp['win'].data_ptr(), sigma.data_ptr(),
            rgb.data_ptr(), S, M, n_rays, inp['res'], inp['C'],
            inp['hidden'], k_dec.TILE, k_dec.BAND_W, bf16)
    return calls


def time_render(libs, inp, rounds=2):
    """{row: {name: [device ms, ...]}} of :func:`render_calls` for each
    library of ``libs`` ({name: path}), in turns: the names in order, then
    reversed, ``rounds`` times."""
    calls = {n: render_calls(lib, inp) for n, lib in libs.items()}
    order = list(libs) + list(libs)[::-1]
    out = {row: {n: [] for n in libs} for row in calls[order[0]]}
    for _ in range(rounds):
        for n in order:
            for row, call in calls[n].items():
                out[row][n].append(_device_ms(call))
    return out


def ptxas_usage(log):
    """{kernel: {'registers', 'spill_stores', 'spill_loads'}} of the
    decode kernels in a ``ptxas -v`` log (usage follows the line that
    names the function; names are the mangled ones)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in KERNELS) else None
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out.setdefault(cur, {})['registers'] = int(m.group(1))
    return out


def _medians(times):
    """{row: {name: median}} of :func:`time_render`'s lists."""
    return {row: {n: statistics.median(v) for n, v in by.items()}
            for row, by in times.items()}


def run(csrc, rounds=2):
    """SASS counts and ptxas usage of ``csrc``'s decode kernels, the
    backward's time with each variant, in turns (base, variants...,
    repeated ``rounds`` times), the ball rows of :func:`time_render` for
    ``csrc``'s build and, where ``csrc`` is another copy, the package's
    own, and, when ``csrc`` is the package's own sources, the kernels'
    errors (:func:`precision`)."""
    same = Path(csrc).resolve() == _build.CSRC.resolve()
    jobs = {'base': lambda: _full_build(csrc, 'base')}
    jobs.update({n: functools.partial(_build_one, csrc, n, e)
                 for n, e in VARIANTS.items()})
    if not same:
        jobs['tree'] = lambda: _full_build(_build.CSRC, 'tree')
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda f: f(), jobs.values())))
    tree = built.pop('tree', None)
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
    libs = {'csrc': base_lib} if same else {'csrc': base_lib,
                                            'tree': tree[0]}
    render = time_render(libs, ball_inputs('cuda'), rounds)
    return dict(
        device=torch.cuda.get_device_name(0), csrc=str(csrc),
        precision=dict(
            training=precision(inp),
            ragged=precision(training_inputs('cuda', **RAGGED))) if same
        else None,
        sass=sass_counts(base_lib), ptxas=ptxas_usage(base_log),
        tree_ptxas=None if same else ptxas_usage(tree[1]),
        variant_ptxas={n: ptxas_usage(b[1]) for n, b in built.items()
                       if b is not None and n != 'base'},
        not_applicable=[n for n, b in built.items() if b is None],
        backward_ms=times, forward_ms=fwd, ball_ms=render,
        ball_median_ms=_medians(render))


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
