#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ssdnerf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ssdnerf_torch/csrc into build/kernels/, then
runs six phases, any failure of which exits non-zero:

1. device: a CUDA card is present; TF32 is switched off for matmuls and
   convolutions, so every plain f32 reference is full f32;
2. each kernel vs its plain PyTorch version on the card, at the shapes of
   the flagship path (max error, and median times by CUDA events): march,
   decode and attention forward, and the decode and attention backward at
   the training shapes;
3. the unconditional-generation slice at flagship width
   (configs/paper_cfgs/ssdnerf_cars_uncond.py, random seeded weights):
   50-step DDIM on 8 scenes, the 8-sweep density rebuild, and a render of
   4 orbit views of 128x128 per scene; outputs are checked and each
   kernel's launch count must have grown;
4. the same slice at 1 scene (2 DDIM steps, 1 density sweep, 1 view), on
   the card and on the CPU (plain versions) with the same weights, noise
   and jitter, compared within stated tolerances;
5. the single-stage training slice at flagship width: 6 ``train_step``s
   of 8 scenes held in a device scene bank of ``cache_size`` rows, on
   synthetic posed images (the port's render of the phase-3 scenes from
   50 orbit views at SRN intrinsics): a warm-up, 4 timed steps (median
   and spread) and one under ``torch.profiler``, whose device time is
   split by the model's three ``train_step.*`` ranges and by kernel
   group; losses, codes, Adam counters, density grids and the launch
   counts of all five kernels are checked;
6. one ``train_step`` of 1 scene (1 inner step, 1024 rays) on the card
   and on the CPU with the same weights and draws: losses and gradients
   w.r.t. the codes, the decoder and the UNet compared.

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
from ssdnerf_torch.models.autodecoders.base import adam_init  # noqa: E402
from ssdnerf_torch.models.decoders.renderer import (  # noqa: E402
    density_jitter)
from ssdnerf_torch.runner.optim import build_optimizers  # noqa: E402

CONFIG = ROOT / 'configs' / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'
SEED = 0
SRN_INTRINSICS = (131.25, 131.25, 64.0, 64.0)
WRAPPERS = {'march': k_march.occupancy_lookup,
            'decode': k_dec.triplane_decode,
            'decode_bwd': k_dec.triplane_decode_backward,
            'attention': k_attn.attention,
            'attention_bwd': k_attn.attention_backward}
SERVING = ('march', 'decode', 'attention')
TRAIN_PARTS = ('train_step.diffusion', 'train_step.inverse',
               'train_step.decoder')
# (group, substring of the kernel's name), most specific first
PORT_KERNELS = (('decode_bwd', 'triplane_decode_bwd'),
                ('decode', 'triplane_decode_kernel'),
                ('attention_bwd', 'attention_bwd'),
                ('attention', 'attention_fwd'),
                ('march', 'march_occupancy'))
KERNEL_META = {
    'march': ('ssdnerf_torch/csrc/march.cu',
              'ssdnerf_tpu/ops/pallas/march.py:79'),
    'decode': ('ssdnerf_torch/csrc/decode.cu',
               'ssdnerf_tpu/ops/pallas/decode.py:138'),
    'decode_bwd': ('ssdnerf_torch/csrc/decode.cu',
                   'ssdnerf_tpu/ops/pallas/decode.py:169'),
    'attention': ('ssdnerf_torch/csrc/attention.cu',
                  'ssdnerf_tpu/ops/pallas/attention.py:44'),
    'attention_bwd': ('ssdnerf_torch/csrc/attention.cu',
                      'ssdnerf_tpu/ops/pallas/attention.py:58'),
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

    def compare(name, tag, kernel, plain, tol, relative=False):
        """max |kernel - plain| <= tol, or with ``relative`` each output's
        max |kernel - plain| / max |plain| <= tol."""
        out, ref = kernel(), plain()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        pairs = [(o.float(), r.float()) for o, r in zip(out, ref)
                 if o is not None]
        err = max((o - r).abs().max().item() for o, r in pairs)
        rel = max(((o - r).abs().max() / r.abs().max()).item()
                  for o, r in pairs)
        for o, _ in pairs:
            check(torch.isfinite(o).all().item(),
                  f'{tag}: non-finite kernel output')
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        shown = rel if relative else err
        log(f'phase 2 {tag}: max_abs_err={err:.3e} max_rel_err={rel:.3e} '
            f'(tol {tol:g} {"relative" if relative else "absolute"}) '
            f'kernel={ms:.4f} ms plain={plain_ms:.4f} ms')
        check(shown <= tol, f'{tag}: error {shown} > {tol}')
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
        # backward: dq, dk, dv from the forward kernel's own output and
        # row log-sum-exps; no atomics, so an absolute bound as in
        # tests/test_torch_gpu.py
        do = torch.randn((32, T_, hd), generator=g).to(dev)
        o, lse = k_attn.attention_forward(q, k, v, scale, with_lse=True)
        compare('attention_bwd', f'attention backward G=32 T={T_} hd={hd}',
                lambda: k_attn.attention_backward(q, k, v, o, lse, do,
                                                  scale),
                lambda: k_attn.attention_backward_plain(q, k, v, do, scale),
                1e-4)

    # decode forward and backward at the training shapes: 8 scenes x 4096
    # rays x K=64 compacted samples, per-ray ray ids, samples 1/74 apart
    # along each ray as a march gives them
    n_rays, K = 4096, 64
    start = torch.rand((S, n_rays, 1, 3), generator=g) * 2 - 1
    step = torch.nn.functional.normalize(
        torch.randn((S, n_rays, 1, 3), generator=g), dim=-1) * (2 / 148)
    xyz_b = (start + step * torch.arange(K)[:, None]).clamp(-1, 1)
    xyz_b = xyz_b.reshape(S, n_rays * K, 3).contiguous().to(dev)
    rid_b = torch.arange(n_rays, dtype=torch.int32).repeat_interleave(
        K).expand(S, -1).contiguous().to(dev)
    dir_b = (torch.randn((S, n_rays, hidden), generator=g) * 0.3).to(dev)
    compare('decode', f'decode colour S={S} M={n_rays * K} (per-ray, K={K})',
            lambda: k_dec.triplane_decode(planes, xyz_b, params, hidden,
                                          rid_b, dir_b),
            lambda: k_dec.triplane_decode_plain(planes, xyz_b, params,
                                                hidden, rid_b, dir_b), 1e-5)
    # f32 atomics sum in a run-dependent order, so the backward's bound is
    # relative to each gradient's largest entry
    g_sig = torch.randn((S, n_rays * K), generator=g).to(dev)
    g_rgb = torch.randn((S, n_rays * K, 3), generator=g).to(dev)
    compare('decode_bwd', f'decode backward S={S} M={n_rays * K} '
            f'(per-ray, K={K})',
            lambda: k_dec.triplane_decode_backward(
                planes, xyz_b, params, hidden, rid_b, dir_b, g_sig, g_rgb),
            lambda: k_dec.triplane_decode_backward_plain(
                planes, xyz_b, params, hidden, rid_b, dir_b, g_sig, g_rgb),
            1e-5, relative=True)
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
        for p in list(model.decoder.parameters()) + list(
                model.diffusion.parameters()):
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        model.decoder.density_net.dense_0.bias -= 3.0
    model.reset_ema()
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
    for name in SERVING:
        check(launches[name] > 0, f'kernel {name} was not launched by the '
              'slice')
    return launches, code, bitfield, dict(ddim_s=t1 - t0, density_s=t2 - t1,
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


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return None if tree is None else tree.to(dev)


def training_data(model, code, bitfield, dev, num_views=50, chunk=5):
    """Synthetic posed images: the port's render of the phase-3 scenes
    from ``num_views`` orbit views of 128x128 at SRN-cars intrinsics."""
    S = code.shape[0]
    poses, intr = orbit_cameras(S, num_views, dev)
    imgs = [model.render(code, bitfield, 128, 128, intr[:, i:i + chunk],
                         poses[:, i:i + chunk])[0]
            for i in range(0, num_views, chunk)]
    return dict(cond_imgs=torch.cat(imgs, 1).contiguous(), cond_poses=poses,
                cond_intrinsics=intr)


def kernel_group(name, event):
    """The group of a device kernel launched under profiler ``event``: the
    port's kernels by name, the rest by the op that launched them."""
    for group, key in PORT_KERNELS:
        if key in name:
            return group
    chain = []
    while event is not None:
        chain.append(event.name)
        event = event.cpu_parent
    if 'aten::convolution_backward' in chain:
        return 'conv bwd (cuDNN)'
    if 'aten::convolution' in chain:
        return 'conv fwd (cuDNN)'
    if any(n.startswith('Optimizer.step') for n in chain):
        return 'torch.optim Adam'
    return 'other torch'


def profile_step(run):
    """Runs ``run`` once under ``torch.profiler`` and splits the device
    time of what it launched (kernels, memcpy, memset), each counted once
    under the op that launched it: by the ``train_step.*`` range whose host
    span holds the launch (autograd's backward thread launches inside the
    span of the ``autograd.grad`` call), and by :func:`kernel_group`.
    Returns (profiled wall ms, device ms, parts, groups, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in TRAIN_PARTS]
    check(len(spans) == len(TRAIN_PARTS), f'profile: ranges {spans}')
    # a range's device-side annotation shares its name: not a kernel
    annotations = {e.name for e in events}
    parts, groups, kernels = {}, {}, {}
    for e in events:
        for k in e.kernels:
            if k.name in annotations:
                continue
            ms = k.duration / 1e3
            part = next((n for n, a, b in spans
                         if a <= e.time_range.start <= b), 'outside')
            parts[part] = parts.get(part, 0.0) + ms
            group = kernel_group(k.name, e)
            groups[group] = groups.get(group, 0.0) + ms
            n, t = kernels.get(k.name, (0, 0.0))
            kernels[k.name] = (n + 1, t + ms)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return wall_ms, sum(parts.values()), parts, groups, top


def phase_train(model, cfg, data, code, dev, timed=4):
    """Flagship train steps of the 8 scenes of ``data``, scene state in a
    device bank of ``cache_size`` rows: one warm-up step, ``timed`` steps
    timed on the host clock to a device synchronise, and one step under
    the profiler.  The bank starts from the scenes' codes, as the config's
    ``cache_load_from`` resumes from a saved code cache; density grids
    start empty."""
    S = data['cond_imgs'].shape[0]
    ess = model.train_cfg['extra_scene_step']
    bank = model.make_cache(dev)
    opts, scheds = build_optimizers(model, cfg.optimizer, cfg.lr_config)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ids = list(range(S))
    code_ = model.code_activation.inverse(code)
    bank.ensure_init(ids, lambda n: code_[:n])
    code0 = bank.code_[:S].clone()
    logs = {}

    def step():
        batch = bank.load(ids)
        batch, out = model.train_step(batch, data, opts, scheds,
                                      generator=gen)
        bank.save(ids, batch['code_'], batch['opt'], batch['density_grid'],
                  batch['density_bitfield'])
        logs.update(out)

    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    steps = 2 + timed
    for i in range(steps):
        if i == steps - 1:
            wall_ms, dev_ms, parts, groups, top = profile_step(step)
            dt = wall_ms / 1e3
        else:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if i > 0:
                times.append(dt)
        vals = {k: v.item() for k, v in logs.items()}
        log(f'phase 5 step {i}{" (warm-up)" if i == 0 else ""}'
            f'{" (profiled)" if i == steps - 1 else ""}: {dt:.4f} s; '
            + ' '.join(f'{k}={v:.5g}' for k, v in sorted(vals.items())))
        for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                  'reg_loss'):
            check(math.isfinite(vals[k]), f'train step {i}: {k} not finite')
    launches = {n: w.launches for n, w in WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = statistics.median(times)
    log(f'phase 5 step time: median {median:.4f} s over steps 1-{timed} '
        f'(min {min(times):.4f}, max {max(times):.4f})')
    log(f'phase 5 profiled step: wall {wall_ms:.1f} ms, device {dev_ms:.1f} '
        f'ms = {dev_ms / 1e3 / median:.3f} of the median step; by part: '
        + ', '.join(f'{k} {v:.1f} ms' for k, v in parts.items()))
    log('phase 5 device time by group: ' + ', '.join(
        f'{k} {v:.1f} ms ({v / dev_ms:.1%})'
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, (n, ms) in top:
        log(f'phase 5 kernel {ms:8.2f} ms x{n:4d} {name[:90]}')
    norm = model.diffusion.norm_factor.item()
    occ = np.unpackbits(bank.density_bitfield[:S].cpu().numpy()).mean()
    moved = (bank.code_[:S] - code0).abs().max().item()
    counters = bank.step[:S].tolist()
    log(f'phase 5 train: {S} scenes, extra_scene_step {ess}, bank '
        f'{bank.cache_size} scenes; peak memory {peak:.2f} GiB; '
        f'norm_factor {norm:.6f}; occupancy {occ:.4f}; codes moved '
        f'{moved:.3e}; Adam steps {counters}; launches {launches}')
    check(math.isfinite(norm) and norm != 1.0, 'norm_factor')
    check(moved > 0, 'codes did not move')
    check(counters == [steps * (ess + 1)] * S, 'Adam step counters')
    check(0.0 < occ < 1.0, 'density grids entirely empty or full')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched by the train steps')
    return launches, dict(step_s=times, median_step_s=median,
                          profiled_wall_ms=wall_ms, device_ms=dev_ms,
                          device_ms_by_part=parts, device_ms_by_group=groups,
                          peak_gib=peak)


def module_grads(module):
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()])


def phase_train_card_vs_cpu(model_cpu, cfg, data, code, dev):
    """One train step of scene 0 with 1 inner step and 1024 rays, on the
    card and on the CPU, from the same weights, codes and draws."""
    tc = dict(model_cpu.train_cfg, extra_scene_step=1, n_inverse_rays=1024,
              n_decoder_rays=1024)
    data = {k: v[:1].cpu() for k, v in data.items()}
    code_ = model_cpu.code_activation.inverse(code[:1].cpu())
    H = model_cpu.grid_size
    batch = dict(code_=code_,
                 density_grid=torch.zeros((1, H ** 3), dtype=torch.float16),
                 density_bitfield=torch.zeros((1, H ** 3 // 8),
                                              dtype=torch.uint8))
    model_cpu.train_cfg = tc
    num_pixels = math.prod(data['cond_imgs'].shape[1:4])
    draws = model_cpu.train_draws(
        1, num_pixels, torch.Generator().manual_seed(SEED + 6))
    # a mid timestep: the SNR weight of the last ones is 0, which would
    # leave nothing to compare
    draws['t'] = torch.tensor([model_cpu.diffusion.num_timesteps // 2])
    outs = {}
    for tag, d in (('card', dev), ('cpu', 'cpu')):
        model = copy.deepcopy(model_cpu).to(d)
        opts, scheds = build_optimizers(model, cfg.optimizer, cfg.lr_config)
        batch_d = to_device(batch, d)
        batch_d['opt'] = adam_init(batch_d['code_'])
        t0 = time.perf_counter()
        out, logs = model.train_step(batch_d, to_device(data, d), opts,
                                     scheds, draws=to_device(draws, d))
        outs[tag] = dict(
            logs={k: v.item() for k, v in logs.items()},
            code_m=out['opt'].m.cpu(), bits=out['density_bitfield'].cpu(),
            unet=module_grads(model.diffusion).cpu(),
            decoder=module_grads(model.decoder).cpu())
        log(f'phase 6 {tag}: {time.perf_counter() - t0:.2f} s')
        del model
    card, cpu = outs['card'], outs['cpu']
    flips = (np.unpackbits(card['bits'].numpy())
             != np.unpackbits(cpu['bits'].numpy())).mean()
    log(f'phase 6 card vs cpu: bitfield flipped share {flips:.2e}')
    for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'reg_loss'):
        a, b = card['logs'][k], cpu['logs'][k]
        rel = abs(a - b) / abs(b)
        log(f'phase 6 {k}: card {a:.7g} cpu {b:.7g} rel_err {rel:.2e} '
            '(tol 1e-4)')
        check(rel <= 1e-4, f'card vs cpu: {k}')
    # gradients: max |card - cpu| / max |cpu| over each whole module; the
    # codes' gradients through the Adam first moment m (zero before the
    # step, so m is a fixed combination of this step's two code gradients)
    for k in ('code_m', 'unet', 'decoder'):
        rel = ((card[k] - cpu[k]).abs().max() / cpu[k].abs().max()).item()
        log(f'phase 6 {k} gradient: max_rel_err {rel:.2e} (tol 1e-3)')
        check(rel <= 1e-3, f'card vs cpu: {k} gradient')


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
    cfg = Config.fromfile(str(CONFIG))
    model_cpu = make_model(SEED)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    serve_launches, code, bitfield, times = phase_slice(model_dev, dev)
    phase_card_vs_cpu(model_cpu, model_dev, dev)
    data = training_data(model_dev, code, bitfield, dev)
    train_launches, train_times = phase_train(model_dev, cfg, data, code,
                                               dev)
    del model_dev
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu(model_cpu, cfg, data, code, dev)

    # launches: the serving kernels' counts from phase 3, the backward
    # kernels' from phase 5 (the path that runs them)
    launches = {n: serve_launches[n] if n in SERVING else train_launches[n]
                for n in WRAPPERS}
    report = [dict(name=name, route='cuda', source=KERNEL_META[name][0],
                   replaces=KERNEL_META[name][1], launches=launches[name],
                   max_abs_err=kernels[name]['max_abs_err'],
                   ms=kernels[name]['ms'], plain_ms=kernels[name]['plain_ms'])
              for name in WRAPPERS]
    log(json.dumps({'kernels': report, 'slice_seconds': times,
                    'train': train_times}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
