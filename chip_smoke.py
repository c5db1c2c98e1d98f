#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ssdnerf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the three CUDA kernels from ssdnerf_torch/csrc into build/kernels/,
then runs four phases, any failure of which exits non-zero:

1. device: a CUDA card is present; TF32 is switched off for matmuls and
   convolutions, so every plain f32 reference is full f32;
2. each kernel vs its plain PyTorch version on the card, at the shapes of
   the flagship path (max abs error, and median times by CUDA events);
3. the unconditional-generation slice at flagship width
   (configs/paper_cfgs/ssdnerf_cars_uncond.py, random seeded weights):
   50-step DDIM on 8 scenes, the 8-sweep density rebuild, and a render of
   4 orbit views of 128x128 per scene; outputs are checked and each
   kernel's launch count must have grown;
4. the same slice at 1 scene (2 DDIM steps, 1 density sweep, 1 view), on
   the card and on the CPU (plain versions) with the same weights, noise
   and jitter, compared within stated tolerances.

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the result JSON.  Imports nothing of JAX.
"""
import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ssdnerf_torch import Config, init_model  # noqa: E402
from ssdnerf_torch.ops.kernels import _build  # noqa: E402
from ssdnerf_torch.ops.kernels import attention as k_attn  # noqa: E402
from ssdnerf_torch.ops.kernels import decode as k_dec  # noqa: E402
from ssdnerf_torch.ops.kernels import march as k_march  # noqa: E402
from ssdnerf_torch.ops import get_cam_rays, near_far_from_aabb  # noqa: E402
from ssdnerf_torch.models.decoders.renderer import (  # noqa: E402
    density_jitter)

CONFIG = ROOT / 'configs' / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'
SEED = 0
SRN_INTRINSICS = (131.25, 131.25, 64.0, 64.0)
WRAPPERS = {'march': k_march.occupancy_lookup,
            'decode': k_dec.triplane_decode,
            'attention': k_attn.attention}
KERNEL_META = {
    'march': ('ssdnerf_torch/csrc/march.cu',
              'ssdnerf_tpu/ops/pallas/march.py:79'),
    'decode': ('ssdnerf_torch/csrc/decode.cu',
               'ssdnerf_tpu/ops/pallas/decode.py:138'),
    'attention': ('ssdnerf_torch/csrc/attention.cu',
                  'ssdnerf_tpu/ops/pallas/attention.py:44'),
}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, warmup=2, reps=7):
    """Median over ``reps`` timed calls (CUDA events) after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def orbit_cameras(num_scenes, num_views, device):
    """Orbit poses at radius 1.3 looking at the origin, SRN-cars
    intrinsics: (S, V, 4, 4) and (S, V, 4)."""
    poses = np.stack([look_at_pose(1.3 * np.array(
        [math.cos(a), 0.3, math.sin(a)]))
        for a in 2 * math.pi * np.arange(num_views) / num_views + 0.3])
    poses = torch.from_numpy(poses).expand(num_scenes, -1, -1, -1)
    intr = torch.tensor(SRN_INTRINSICS).expand(num_scenes, num_views, 4)
    return poses.contiguous().to(device), intr.contiguous().to(device)


# ---------------------------------------------------------------- phases
def phase_device():
    check(torch.cuda.is_available(), 'no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'phase 1 device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}; allow_tf32 matmul='
        f'{torch.backends.cuda.matmul.allow_tf32} cudnn='
        f'{torch.backends.cudnn.allow_tf32}')
    return torch.device('cuda')


def phase_kernels(dev):
    """Each kernel vs its plain version at flagship shapes."""
    g = torch.Generator().manual_seed(SEED + 11)
    results = {}

    def compare(name, tag, kernel, plain, tol):
        out, ref = kernel(), plain()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(out, ref) if o is not None)
        for o in out:
            if o is not None:
                check(torch.isfinite(o.float()).all().item(),
                      f'{tag}: non-finite kernel output')
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        log(f'phase 2 {tag}: max_abs_err={err:.3e} (tol {tol:g}) '
            f'kernel={ms:.4f} ms plain={plain_ms:.4f} ms')
        check(err <= tol, f'{tag}: max abs err {err} > {tol}')
        results.setdefault(name, dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, shape=tag))

    # march: S=8 scenes, R=4*128^2 rays, T=128 slots; real orbit rays and
    # a random 10%-occupancy bitfield
    S, V, H, T = 8, 4, 64, 128
    poses, intr = orbit_cameras(S, V, dev)
    ro, rd = get_cam_rays(poses, intr, 128, 128)
    ro, rd = ro.reshape(S, -1, 3), rd.reshape(S, -1, 3)
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3, device=dev)
    nears, fars = near_far_from_aabb(ro, rd, aabb, 0.2)
    dtg = torch.zeros(S, device=dev)
    idx = k_march.march_indices(ro, rd, nears, fars, dtg, T, H, 1.0, 256)
    idx = idx.reshape(S, -1).contiguous()
    bits = (torch.rand((S, H ** 3 // 8, 8), generator=g) < 0.1).to(
        torch.int32)
    bitfield = (bits << torch.arange(8, dtype=torch.int32)).sum(-1).to(
        torch.uint8).to(dev)
    compare('march', f'march S={S} R={ro.shape[1]} T={T}',
            lambda: k_march.occupancy_lookup(idx, bitfield),
            lambda: k_march.occupancy_lookup_plain(idx, bitfield), 0.0)

    # decode: flagship planes (3 x 6 x 128^2), hidden 64
    C, res, hidden = 6, 128, 64
    planes = torch.randn((S, 3, res, res, C), generator=g).to(dev)
    n_params = hidden * 3 * C + 5 * hidden + 4
    params = (torch.randn(n_params, generator=g) * 0.2).to(dev)
    n_rays, M = 4 * 128 * 128, (4 * 128 * 128 // 16) * 512
    xyz = (torch.rand((S, M, 3), generator=g) * 2 - 1).to(dev)
    rid = torch.randint(0, n_rays, (S, M), generator=g,
                        dtype=torch.int32).to(dev)
    dir_out = (torch.randn((S, n_rays, hidden), generator=g) * 0.3).to(dev)
    compare('decode', f'decode colour S={S} M={M} (packed, P=512)',
            lambda: k_dec.triplane_decode(planes, xyz, params, hidden, rid,
                                          dir_out),
            lambda: k_dec.triplane_decode_plain(planes, xyz, params, hidden,
                                                rid, dir_out), 1e-5)
    xyz_d = (torch.rand((S, H ** 3, 3), generator=g) * 2 - 1).to(dev)
    compare('decode', f'decode density-only S={S} M={H ** 3}',
            lambda: k_dec.triplane_decode(planes, xyz_d, params, hidden),
            lambda: k_dec.triplane_decode_plain(planes, xyz_d, params,
                                                hidden), 1e-5)

    # attention: G = batch 8 x 4 heads at the 32^2, 16^2 and 8^2 levels
    for T_, hd in ((1024, 64), (256, 128), (64, 128)):
        q, k, v = (torch.randn((32, T_, hd), generator=g).to(dev)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(hd)
        compare('attention', f'attention G=32 T={T_} hd={hd}',
                lambda: k_attn.attention(q, k, v, scale),
                lambda: k_attn.attention_plain(q, k, v, scale), 2e-5)
    return results


def make_model(seed):
    """Flagship model with seeded random weights on the CPU: the JAX
    package's init plus N(0, 0.02) on every parameter (the init zeroes
    proj / conv_2 / out_conv / dir_net, which would hide attention and
    the direction branch).  The density bias is lowered by 3 so that part
    of every density grid is empty, as in a real scene: with random
    weights every voxel would otherwise be occupied and the march would
    test nothing."""
    model = init_model(Config.fromfile(str(CONFIG)), 'cpu', seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        model.decoder.density_net.dense_0.bias -= 3.0
    return model


def phase_slice(model, dev):
    """val_uncond (as its two halves, timed apart) + render at flagship
    width on the card."""
    S, V, h, w = 8, 4, 128, 128
    tcfg = model.test_cfg
    g = torch.Generator().manual_seed(SEED + 2)
    noise = torch.randn((S,) + model.code_size, generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    poses, intr = orbit_cameras(S, V, dev)
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code = model.sample_codes(noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grid, bitfield = model.rebuild_density(code, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    img, depth = model.render(code, bitfield, h, w, intr, poses)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    log(f'phase 3 slice: DDIM {tcfg["num_timesteps"]} steps x {S} scenes '
        f'{t1 - t0:.3f} s; density rebuild {tcfg.get("density_step", 8)} '
        f'sweeps {t2 - t1:.3f} s; render {S}x{V}x{h}x{w} {t3 - t2:.3f} s; '
        f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    sat = model.decoder.sigmoid_saturation
    occ = np.unpackbits(bitfield.cpu().numpy()).mean()
    log(f'phase 3 outputs: code {tuple(code.shape)} |code|max='
        f'{code.abs().max().item():.3f}; occupancy {occ:.4f}; image '
        f'{tuple(img.shape)} range [{img.min().item():.4f}, '
        f'{img.max().item():.4f}]; launches {launches}')
    check(code.shape == (S,) + model.code_size, 'code shape')
    check(img.shape == (S, V, h, w, 3) and depth.shape == (S, V, h, w),
          'image shape')
    for name, t in (('code', code), ('grid', grid.float()), ('image', img),
                    ('depth', depth)):
        check(torch.isfinite(t).all().item(), f'{name} not finite')
    # the colour head's sigmoid saturation widens [0, 1] by `sat`
    check(img.min().item() >= -sat - 1e-6 and img.max().item() <= 1 + sat
          + 1e-6, 'image outside [0, 1] (+- sigmoid saturation)')
    check(0.0 < occ < 1.0, 'density grids entirely empty or full')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched by the slice')
    return launches, dict(ddim_s=t1 - t0, density_s=t2 - t1,
                          render_s=t3 - t2)


def phase_card_vs_cpu(model_cpu, model_dev, dev):
    """1 scene, 2 DDIM steps, 1 density sweep, 1 view: the card against
    the CPU's plain versions, same weights, noise and jitter."""
    cfg = dict(model_cpu.test_cfg, num_timesteps=2, density_step=1)
    g = torch.Generator().manual_seed(SEED + 4)
    noise = torch.randn((1,) + model_cpu.code_size, generator=g)
    jitter = density_jitter(model_cpu.grid_size, model_cpu.decoder.bound, 1,
                            g, 'cpu')
    poses, intr = orbit_cameras(1, 1, 'cpu')
    outs = {}
    for tag, model, d in (('card', model_dev, dev), ('cpu', model_cpu,
                                                     'cpu')):
        t0 = time.perf_counter()
        saved, model.test_cfg = model.test_cfg, cfg
        try:
            code, grid, bitfield = model.val_uncond(
                noise.to(d), jitter=jitter.to(d))
            img, _ = model.render(code, bitfield, 128, 128, intr.to(d),
                                  poses.to(d))
        finally:
            model.test_cfg = saved
        outs[tag] = [t.cpu() for t in (code, grid, bitfield, img)]
        log(f'phase 4 {tag}: {time.perf_counter() - t0:.2f} s')
    (c1, g1, b1, i1), (c0, g0, b0, i0) = outs['card'], outs['cpu']
    code_err = (c1 - c0).abs().max().item()
    grid_rel = ((g1.float() - g0.float()).abs()
                / (g0.float().abs() + 1e-3)).max().item()
    flips = (np.unpackbits(b1.numpy()) != np.unpackbits(b0.numpy())).mean()
    img_max = (i1 - i0).abs().max().item()
    img_mean = (i1 - i0).abs().mean().item()
    log(f'phase 4 card vs cpu: code max_abs_err={code_err:.3e} (tol 1e-3); '
        f'density max_rel_err={grid_rel:.3e} (tol 5e-3); bitfield flipped '
        f'share={flips:.2e} (tol 1e-3); image max_abs_err={img_max:.3e} '
        f'(tol 2e-2) mean={img_mean:.3e} (tol 1e-3)')
    check(code_err <= 1e-3, 'card vs cpu: codes')
    check(grid_rel <= 5e-3, 'card vs cpu: density grid')
    check(flips <= 1e-3, 'card vs cpu: bitfield')
    check(img_max <= 2e-2 and img_mean <= 1e-3, 'card vs cpu: image')


def main():
    log(f'torch {torch.__version__} cuda {torch.version.cuda} python '
        f'{sys.version.split()[0]}')
    dev = phase_device()
    nvcc = subprocess.run([_build._nvcc(), '--version'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log('nvcc:', ' | '.join(nvcc[-2:]))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log('card:', smi)
    lib, build_s, build_log = _build.build_info()
    log(f'kernel build: {build_s:.1f} s -> {lib.relative_to(ROOT)}')
    for line in build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ptxas:', line.strip())
    _build.library()

    kernels = phase_kernels(dev)
    model_cpu = make_model(SEED)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    launches, times = phase_slice(model_dev, dev)
    phase_card_vs_cpu(model_cpu, model_dev, dev)

    report = [dict(name=name, route='cuda', source=KERNEL_META[name][0],
                   replaces=KERNEL_META[name][1], launches=launches[name],
                   max_abs_err=kernels[name]['max_abs_err'],
                   ms=kernels[name]['ms'], plain_ms=kernels[name]['plain_ms'])
              for name in WRAPPERS]
    log(json.dumps({'kernels': report, 'slice_seconds': times}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
