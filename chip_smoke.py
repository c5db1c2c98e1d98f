#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ssdnerf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ssdnerf_torch/csrc into build/kernels/, then
runs six phases, any failure of which exits non-zero:

1. device: a CUDA card is present; TF32 is switched off for matmuls and
   convolutions, so every plain f32 reference is full f32;
2. each kernel vs its plain PyTorch version on the card, at the shapes of
   the flagship path (max error, median times by CUDA events, the least
   time the card could take for the same work, and the time of one
   PyTorch call computing the same function where there is one): march,
   the probe's per-row occupancy counts, decode and attention forward, the
   decode and attention backward at the training shapes, and the decode
   forward, the fused decode + composite and the banded decode on the
   packed layouts of a coherent render (a ball seen by 4 look-at views of
   128x128 per scene, where the banded guard holds), each decode row in
   f32 and in the bf16 operand mode; the bounds of the kernels whose
   products run on the tensor cores (decode, attention) count those
   products in three TF32 passes for f32 operands and one pass (TF32 for
   the decode, bf16 for the attention) for bf16 ones, with the all-f32
   bound printed beside; the kernels that
   ``scaled_dot_product_attention`` runs are named from a profile;
   then the probe tool's path (``python -m
   ssdnerf_torch.tools.march_scalar_probe``) once, whose kernel must have
   launched;
3. the unconditional-generation slice at flagship width
   (configs/paper_cfgs/ssdnerf_cars_uncond.py, random seeded weights; the
   decoder in its default bf16 ``compute_dtype``, as shipped): 50-step
   DDIM on 8 scenes, the 8-sweep density rebuild, and a render of 4 orbit
   views of 128x128 per scene; outputs are checked and each kernel's
   launch count must have grown.  Then the render variants: the
   same scenes rendered with the decoder fields ``fused_composite`` and
   ``banded_decode`` against the split render, and the same codes over the
   ball of phase 2, where the banded guard must engage; the wall times and
   the guard's outcomes are printed, and both kernels must have launched;
4. the same slice at 1 scene (2 DDIM steps, 1 density sweep, 1 view), on
   the card and on the CPU (plain versions) with the same weights, noise
   and jitter, compared within stated tolerances (the bf16 decode's in
   the CPU's own bf16-vs-f32 gap), and the two render variants of one
   ball view on the card and on the CPU; each again with the decoder's
   ``compute_dtype`` 'float32', the path of the f32 decode kernels;
5. the single-stage training slice at flagship width: 6 ``train_step``s
   of 8 scenes held in a device scene bank of ``cache_size`` rows, on
   synthetic posed images (the port's render of the phase-3 scenes from
   50 orbit views at SRN intrinsics): a warm-up, 4 timed steps (median
   and spread) and one under ``torch.profiler``, whose device time is
   split by the model's three ``train_step.*`` ranges and by kernel
   group; losses, codes, Adam counters, density grids and the launch
   counts of all five kernels are checked;
6. one ``train_step`` of 1 scene (1 inner step, 1024 rays) on the card
   and on the CPU with the same weights and draws, in bf16 and in f32
   (the f32 decode backward's path): losses and gradients w.r.t. the
   codes, the decoder and the UNet compared;
7. the bf16 UNet path: generation with configs/new_cfgs/
   ssdnerf_cars_uncond_bf16.py (a bf16 UNet with f32 parameters) at batch
   8 (50-step DDIM, density rebuild, render of 4 orbit views of 128x128),
   and the flagship's DDIM under ``use_fp16`` (bf16 autocast), beside
   phase 3's f32 times, the bf16 attention's launch count growing; both
   modes at 1 scene and 2 DDIM steps on the card against the CPU; a few
   ``train_step``s of the bf16 configuration at 8 scenes (median, device
   time by range and kernel group), where the bf16 attention backward must
   launch; and one line of device times of a flagship UNet forward at
   batch 8 in IEEE f32, TF32 (switched on here only), f32 channels-last and
   bf16.  Phase 2 holds the bf16 attention kernels against their plain
   bf16 versions at the three flagship levels, bounded at the dense bf16
   tensor rate (at T=1024, hd=64 the forward is the wgmma kernel of
   csrc/attention_fwd_sm90.cu).

The line before the last is the card's name and power limit from
nvidia-smi; the last line is the result JSON.  Imports nothing of JAX.
"""
import contextlib
import copy
import json
import math
import re
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
from ssdnerf_torch.ops import (  # noqa: E402
    get_cam_rays, near_far_from_aabb, packbits, t_at_step)
from ssdnerf_torch.ops.packing import (  # noqa: E402
    band_keys_and_payload, banded_windows, pack_groups_banded)
from ssdnerf_torch.models.autodecoders.base import adam_init  # noqa: E402
from ssdnerf_torch.models.decoders.renderer import (  # noqa: E402
    GROUP_RAYS, density_jitter, dt_bounds, march_samples, slot_samples,
    volume_render)
from ssdnerf_torch.models.decoders.triplane import (  # noqa: E402
    TriPlaneDecoder)
from ssdnerf_torch.runner.optim import build_optimizers  # noqa: E402
from ssdnerf_torch.tools import march_scalar_probe  # noqa: E402
from ssdnerf_torch.tools.march_scalar_probe import median_ms  # noqa: E402

CONFIG = ROOT / 'configs' / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'
CONFIG_BF16 = ROOT / 'configs' / 'new_cfgs' / 'ssdnerf_cars_uncond_bf16.py'
SEED = 0
SRN_INTRINSICS = (131.25, 131.25, 64.0, 64.0)
# H100 SXM peaks the bounds are taken against (NVIDIA's data sheet): f32
# outside the tensor cores (the decode and march kernels, the attention's
# softmax), dense TF32 on the tensor cores (the attention's products, run
# in three passes) and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# each kernel's wrapper and the attribute its launches are counted in
WRAPPERS = {'march': (k_march.occupancy_lookup, 'launches'),
            'march_popcount': (k_march.occupied_counts, 'launches'),
            'decode': (k_dec.triplane_decode, 'launches'),
            'decode_bwd': (k_dec.triplane_decode_backward, 'launches'),
            'decode_composite': (k_dec.triplane_decode_composite,
                                 'launches'),
            'decode_banded': (k_dec.triplane_decode_banded, 'launches'),
            'decode_bf16': (k_dec.triplane_decode, 'launches_bf16'),
            'decode_bwd_bf16': (k_dec.triplane_decode_backward,
                                'launches_bf16'),
            'decode_composite_bf16': (k_dec.triplane_decode_composite,
                                      'launches_bf16'),
            'decode_banded_bf16': (k_dec.triplane_decode_banded,
                                   'launches_bf16'),
            'attention': (k_attn.attention, 'launches'),
            'attention_bwd': (k_attn.attention_backward, 'launches'),
            'attention_bf16': (k_attn.attention, 'launches_bf16'),
            'attention_bwd_bf16': (k_attn.attention_backward,
                                   'launches_bf16')}
# the shipped configurations decode in bf16 (the decoder's default
# compute_dtype); the f32 decode kernels run on the f32 paths of phases 4
# and 6
SERVING = ('march', 'decode_bf16', 'attention')
TRAIN = ('march', 'decode_bf16', 'decode_bwd_bf16', 'attention',
         'attention_bwd')
F32_RENDER = ('decode', 'decode_composite', 'decode_banded')
F32_TRAIN = ('decode', 'decode_bwd')
PROBE = ('march_popcount',)
VARIANTS = {'decode_composite_bf16': 'fused_composite',
            'decode_banded_bf16': 'banded_decode'}
TRAIN_PARTS = ('train_step.diffusion', 'train_step.inverse',
               'train_step.decoder')
# (group, pattern of the kernel's name), most specific first; the decode
# kernels' bf16 instances have a last template argument true (Lb1E
# mangled)
_BF16 = r'(<[^<>]*true>|Lb1E)'
PORT_KERNELS = (('decode_bwd_bf16', 'triplane_decode_bwd_kernel.*' + _BF16),
                ('decode_composite_bf16',
                 'triplane_decode_composite_kernel.*' + _BF16),
                ('decode_banded_bf16',
                 'triplane_decode_banded_kernel.*' + _BF16),
                ('decode_bf16', 'triplane_decode_kernel.*' + _BF16),
                ('decode_bwd', 'triplane_decode_bwd'),
                ('decode_composite', 'triplane_decode_composite'),
                ('decode_banded', 'triplane_decode_banded'),
                ('decode', 'triplane_decode_kernel'),
                ('attention_bwd_bf16', 'attention_bwd.*(bf16|bfloat16)'),
                ('attention_bf16', 'attention_fwd_(bf16|sm90)'),
                ('attention_bwd', 'attention_bwd'),
                ('attention', 'attention_fwd'),
                ('march', 'march_occupancy'),
                ('march_popcount', 'march_popcount'))
KERNEL_META = {
    'march': ('ssdnerf_torch/csrc/march.cu',
              'ssdnerf_tpu/ops/pallas/march.py:79'),
    'march_popcount': ('ssdnerf_torch/csrc/march.cu',
                       'tools/march_scalar_probe.py:36'),
    'decode': ('ssdnerf_torch/csrc/decode.cu',
               'ssdnerf_tpu/ops/pallas/decode.py:138'),
    'decode_bwd': ('ssdnerf_torch/csrc/decode.cu',
                   'ssdnerf_tpu/ops/pallas/decode.py:169'),
    'decode_composite': ('ssdnerf_torch/csrc/decode_composite.cu',
                         'ssdnerf_tpu/ops/pallas/decode.py:513'),
    'decode_banded': ('ssdnerf_torch/csrc/decode_banded.cu',
                      'ssdnerf_tpu/ops/pallas/decode.py:650'),
    'decode_bf16': ('ssdnerf_torch/csrc/decode.cu',
                    'ssdnerf_tpu/ops/pallas/decode.py:138'),
    'decode_bwd_bf16': ('ssdnerf_torch/csrc/decode.cu',
                        'ssdnerf_tpu/ops/pallas/decode.py:169'),
    'decode_composite_bf16': ('ssdnerf_torch/csrc/decode_composite.cu',
                              'ssdnerf_tpu/ops/pallas/decode.py:513'),
    'decode_banded_bf16': ('ssdnerf_torch/csrc/decode_banded.cu',
                           'ssdnerf_tpu/ops/pallas/decode.py:650'),
    'attention': ('ssdnerf_torch/csrc/attention.cu',
                  'ssdnerf_tpu/ops/pallas/attention.py:44'),
    'attention_bwd': ('ssdnerf_torch/csrc/attention.cu',
                      'ssdnerf_tpu/ops/pallas/attention.py:58'),
    # the path's shape (T=1024, hd=64) takes the wgmma forward; others
    # attention.cu's mma.sync one
    'attention_bf16': ('ssdnerf_torch/csrc/attention_fwd_sm90.cu',
                       'ssdnerf_tpu/ops/pallas/attention.py:44'),
    'attention_bwd_bf16': ('ssdnerf_torch/csrc/attention.cu',
                           'ssdnerf_tpu/ops/pallas/attention.py:58'),
}


def reset_launches():
    for wrapper, attr in WRAPPERS.values():
        setattr(wrapper, attr, 0)


@contextlib.contextmanager
def decode_dtype(model, dtype):
    """The model's decoders (live and EMA) at ``compute_dtype`` ``dtype``
    for the block."""
    decs = [d for d in (model.decoder, model.decoder_ema) if d is not None]
    saved = [d.compute_dtype for d in decs]
    for d in decs:
        d.compute_dtype = dtype
    try:
        yield
    finally:
        for d, c in zip(decs, saved):
            d.compute_dtype = c


def bf16_errors(got, ref):
    """(max |got - ref|, mean |got - ref|) / max |ref|, and the share of
    elements more than 1e-5 of max |ref| off: the bf16 decode's tolerance
    is 2^-8 and 1e-5 on the first two (a rounding to bf16 that falls the
    other way after f32 sums in another order moves an element by about
    one ulp of its inputs; such flips are rare)."""
    got, ref = got.float(), ref.float()
    top = ref.abs().max()
    err = (got - ref).abs() / top
    return err.max().item(), err.mean().item(), (err > 1e-5).float().mean(
        ).item()


def launch_counts():
    return {n: getattr(w, attr) for n, (w, attr) in WRAPPERS.items()}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


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


def sdpa(q, k, v, scale):
    """torch's scaled_dot_product_attention on (G, T, hd): the library
    yardstick of the attention kernels, which the port never calls."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, None], k[:, None], v[:, None], scale=scale)[:, 0]


def bound_ms(flops, moved, tensor_flops=0, tensor_rate=PEAK_TF32_FLOPS):
    """The least time the card could take for work of ``flops`` f32
    operations outside the tensor cores and ``tensor_flops`` ones on them
    (TF32, or at ``tensor_rate``), moving ``moved`` bytes (each input read
    once, each output written once): the largest of the three times; and
    whether operations or bytes set it."""
    t_ops = max(flops / PEAK_F32_FLOPS, tensor_flops / tensor_rate)
    t_bytes = moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def decode_flops(C, hidden, colour=True):
    """f32 operations of one point's decode: the 4-tap bilinear samples of
    3 planes x C channels (9 each), the base Linear (2 a MAC, plus bias),
    SiLU (4) and the density head (2 a MAC); colour adds the dir_out add, a
    second SiLU and the 3-wide head."""
    ops = 27 * C + hidden * (2 * 3 * C + 1) + 4 * hidden + 2 * hidden
    return ops + (hidden + 4 * hidden + 6 * hidden if colour else 0)


def decode_products(C, hidden):
    """Operations of one point's base Linear product (2 a MAC), which the
    decode kernels run on the tensor cores (csrc/decode.cu); the backward
    runs three such products a point."""
    return 2 * 3 * C * hidden


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def device_profile(fn, calls=30, tries=3, expect=None):
    """Device ms a call of ``fn`` spends in each kernel (or copy) it
    launches, by name: ``torch.profiler`` over ``calls`` calls after a
    warm-up call.  Unlike a CUDA-event time of one call, this leaves out
    the host's launch latency, which a kernel of tens of microseconds does
    not hide.  A trace in which a kernel reads 0 device ms, that holds no
    kernel, or that holds none of the group ``expect`` (of PORT_KERNELS)
    is taken again, up to ``tries`` times; then the phase fails.
    ``device_profile.retries`` counts the retakes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        # a range's device-side annotation shares its name: not a kernel
        annotations = {e.name for e in events
                       if e.device_type == DeviceType.CPU}
        ms = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and e.name not in annotations:
                ms[e.name] = ms.get(e.name, 0.0) + (
                    e.time_range.elapsed_us() / (1e3 * calls))
        zero = sorted(n for n, t in ms.items() if t <= 0)
        found = expect is None or any(kernel_group(n, None) == expect
                                      for n in ms)
        if ms and not zero and found:
            return ms
        device_profile.retries += 1
    raise AssertionError(f'device_profile: {tries} traces of {calls} calls; '
                         f'the last read 0 ms for {zero}, '
                         f'{"found" if found else "lacked"} {expect}, '
                         f'{len(ms)} kernels')


device_profile.retries = 0


def phase_kernels(dev):
    """Each kernel vs its plain version at flagship shapes; the names of
    the kernels of the attention's library yardstick."""
    g = torch.Generator().manual_seed(SEED + 11)
    results = {}

    def compare(name, tag, kernel, plain, tol, flops, moved,
                relative=False, library=None, tensor_flops=0,
                tensor_rate=PEAK_TF32_FLOPS, passes=3, f32_plain=None):
        """max |kernel - plain| <= tol (a number, or one per output), or
        with ``relative`` each output's max |kernel - plain| / max |plain|
        <= tol; the times of kernel, plain and ``library`` (one PyTorch
        call computing the same function), and the bound of ``flops`` f32
        and ``tensor_flops`` tensor-core operations (at ``tensor_rate``,
        ``passes`` a product) moving ``moved`` bytes.  A bf16 decode row
        passes ``f32_plain``, the plain version in f32 on the same
        bf16-valued inputs: each output's mean |kernel - plain| / max
        |plain| must be <= 1e-5 (:func:`bf16_errors`), and its relative L2
        distance from the plain version at most half of the plain
        version's from ``f32_plain`` (the bf16-vs-f32 gap), which a kernel
        that skipped the bf16 roundings would not meet."""
        out, ref = kernel(), plain()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        pairs = [(o.float(), r.float()) for o, r in zip(out, ref)
                 if o is not None]
        tols = tol if isinstance(tol, tuple) else (tol,) * len(pairs)
        errs = [(o - r).abs().max().item() for o, r in pairs]
        rels = [((o - r).abs().max() / r.abs().max()).item()
                for o, r in pairs]
        for o, _ in pairs:
            check(torch.isfinite(o).all().item(),
                  f'{tag}: non-finite kernel output')
        if f32_plain is not None:
            ref32 = f32_plain()
            ref32 = ref32 if isinstance(ref32, tuple) else (ref32,)
            ref32 = [r.float() for r, o in zip(ref32, out) if o is not None]
            means = [bf16_errors(o, r)[1] for o, r in pairs]
            dists = [l2(o, r) for o, r in pairs]
            gaps = [l2(r32, r) for r32, (_, r) in zip(ref32, pairs)]
            log(f'phase 2 {tag}: mean rel_err ' + ', '.join(
                f'{m:.3e}' for m in means) + ' (tol 1e-05); rel_l2 to '
                'plain / bf16-vs-f32 gap ' + ', '.join(
                    f'{d:.3e}/{gp:.3e}' for d, gp in zip(dists, gaps))
                + ' (tol 0.5 gap)')
            for m, d, gp in zip(means, dists, gaps):
                check(m <= 1e-5, f'{tag}: mean error {m} > 1e-5')
                check(d <= 0.5 * gp, f'{tag}: rel_l2 {d} to the bf16 plain '
                      f'version > half the bf16-vs-f32 gap {gp}')
        # median of 7 CUDA-event timings of one call, after 2 warm-ups
        ms, plain_ms, lib_ms = (
            None if fn is None else median_ms(fn, dev, 7, warmup=2)
            for fn in (kernel, plain, library))
        dev_ms = sum(device_profile(kernel, expect=name).values())
        lib_dev_ms = (None if library is None
                      else sum(device_profile(library).values()))
        check(dev_ms > 0 and (lib_dev_ms is None or lib_dev_ms > 0),
              f'{tag}: the profiler read no device time')
        b_ms, b_by = bound_ms(flops, moved, tensor_flops, tensor_rate)
        # the same work with the products in f32 outside the tensor cores,
        # one pass: the bound before the products moved onto them
        f32_ms, _ = bound_ms(flops + tensor_flops / passes, moved)
        shown = rels if relative else errs
        log(f'phase 2 {tag}: max_abs_err={max(errs):.3e} max_rel_err='
            f'{max(rels):.3e} (tol {tol} {"relative" if relative else "absolute"}) '
            f'kernel={ms:.4f} ms (device {dev_ms:.4f}) plain={plain_ms:.4f} '
            f'ms library='
            + ('none ' if lib_ms is None else
               f'{lib_ms:.4f} ms (device {lib_dev_ms:.4f}) kernel/library '
               f'device={dev_ms / lib_dev_ms:.2f}x ')
            + f'bound={b_ms:.4f} ms ({b_by}: {flops / 1e9:.3f} GFLOP f32'
            + (f' + {tensor_flops / 1e9:.3f} GFLOP '
               f'{"TF32" if tensor_rate == PEAK_TF32_FLOPS else "bf16"} x'
               f'{passes}; all-f32 bound {f32_ms:.4f} ms'
               if tensor_flops else '')
            + f', {moved / 1e6:.1f} MB)')
        for e, t in zip(shown, tols):
            check(e <= t, f'{tag}: error {e} > {t}')
        results.setdefault(name, dict(max_abs_err=max(errs), ms=ms,
                                      plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=b_ms, bound_by=b_by,
                                      bound_all_f32_ms=f32_ms,
                                      device_ms=dev_ms,
                                      library_device_ms=lib_dev_ms,
                                      shape=tag))

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
            lambda: k_march.occupancy_lookup_plain(idx, bitfield), 0.0,
            2 * idx.numel(), nbytes(idx, bitfield) + idx.numel())
    # the probe's per-row counts over the same 67M indices, 1024 a row,
    # each scene's bitfield as its byte table: bytes 4 a sample plus the
    # tables, and the counts
    ji = idx.reshape(-1, 1024)
    compare('march_popcount', f'march_popcount rows={ji.shape[0]} x 1024 '
            f'(S={S})',
            lambda: k_march.occupied_counts(ji, bitfield),
            lambda: k_march.occupied_counts_plain(ji, bitfield), 0.0,
            2 * ji.numel(), nbytes(ji, bitfield) + 4 * ji.shape[0])

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
                                                rid, dir_out), 1e-5,
            S * M * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes, xyz, params, rid, dir_out) + S * M * 16,
            tensor_flops=3 * S * M * decode_products(C, hidden))
    xyz_d = (torch.rand((S, H ** 3, 3), generator=g) * 2 - 1).to(dev)
    compare('decode', f'decode density-only S={S} M={H ** 3}',
            lambda: k_dec.triplane_decode(planes, xyz_d, params, hidden),
            lambda: k_dec.triplane_decode_plain(planes, xyz_d, params,
                                                hidden), 1e-5,
            S * H ** 3 * (decode_flops(C, hidden, colour=False)
                          - decode_products(C, hidden)),
            nbytes(planes, xyz_d, params) + S * H ** 3 * 4,
            tensor_flops=3 * S * H ** 3 * decode_products(C, hidden))
    # the bf16 operand mode at the same shapes: bf16 planes (half the
    # bytes) and weights, one TF32 pass of the products (exact for bf16
    # values); within half a bf16 ulp of the largest entry of the plain
    # version at the same rounding points (2^-8 relative), a mean within
    # 1e-5 of it, and within half the gap to f32 (compare's f32_plain)
    planes_b = planes.bfloat16()
    planes_f = planes_b.float()
    params_b = k_dec.round_weights(params, hidden, 3 * C)
    compare('decode_bf16', f'decode bf16 colour S={S} M={M} (packed, P=512)',
            lambda: k_dec.triplane_decode(planes_b, xyz, params_b, hidden,
                                          rid, dir_out),
            lambda: k_dec.triplane_decode_plain(planes_b, xyz, params_b,
                                                hidden, rid, dir_out),
            2.0 ** -8,
            S * M * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes_b, xyz, params, rid, dir_out) + S * M * 16,
            relative=True, tensor_flops=S * M * decode_products(C, hidden),
            passes=1,
            f32_plain=lambda: k_dec.triplane_decode_plain(
                planes_f, xyz, params_b, hidden, rid, dir_out))
    compare('decode_bf16', f'decode bf16 density-only S={S} M={H ** 3}',
            lambda: k_dec.triplane_decode(planes_b, xyz_d, params_b, hidden),
            lambda: k_dec.triplane_decode_plain(planes_b, xyz_d, params_b,
                                                hidden), 2.0 ** -8,
            S * H ** 3 * (decode_flops(C, hidden, colour=False)
                          - decode_products(C, hidden)),
            nbytes(planes_b, xyz_d, params) + S * H ** 3 * 4,
            relative=True,
            tensor_flops=S * H ** 3 * decode_products(C, hidden), passes=1,
            f32_plain=lambda: k_dec.triplane_decode_plain(
                planes_f, xyz_d, params_b, hidden))

    # attention: G = batch 8 x 4 heads at the 32^2, 16^2 and 8^2 levels.
    # Bound: the products (4 hd T^2 forward, 10 hd T^2 backward a program)
    # in three TF32 passes on the tensor cores, the softmax's elementwise
    # work (4 T^2 forward, 8 T^2 backward) in f32, or the bytes
    for T_, hd in ((1024, 64), (256, 128), (64, 128)):
        q, k, v = (torch.randn((32, T_, hd), generator=g).to(dev)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(hd)
        # library: one f32 scaled_dot_product_attention call (TF32 off)
        compare('attention', f'attention G=32 T={T_} hd={hd}',
                lambda: k_attn.attention(q, k, v, scale),
                lambda: k_attn.attention_plain(q, k, v, scale), 2e-5,
                32 * T_ * T_ * 4, 4 * nbytes(q),
                library=lambda: sdpa(q, k, v, scale),
                tensor_flops=3 * 32 * T_ * T_ * 4 * hd)
        # backward: dq, dk, dv from the forward kernel's own output and
        # row log-sum-exps; no atomics, so an absolute bound as in
        # tests/test_torch_gpu.py
        do = torch.randn((32, T_, hd), generator=g).to(dev)
        _, lse, o = k_attn.attention_forward(q, k, v, scale, with_lse=True)
        # library: the backward of that call (its forward run once, before)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out_lib = sdpa(*leaves, scale)
        compare('attention_bwd', f'attention backward G=32 T={T_} hd={hd}',
                lambda: k_attn.attention_backward(q, k, v, o, lse, do,
                                                  scale),
                lambda: k_attn.attention_backward_plain(q, k, v, do, scale),
                1e-4, 32 * T_ * T_ * 8,
                nbytes(q, k, v, o, lse, do) + 3 * nbytes(q),
                library=lambda: torch.autograd.grad(out_lib, leaves, do,
                                                    retain_graph=True),
                tensor_flops=3 * 32 * T_ * T_ * 10 * hd)
        if T_ == 1024:
            lib_kernels = dict(
                forward=sorted(device_profile(lambda: sdpa(q, k, v, scale))),
                backward=sorted(device_profile(lambda: torch.autograd.grad(
                    out_lib, leaves, do, retain_graph=True))))
            log(f'phase 2 library kernels at T={T_}: {lib_kernels}')
        del leaves, out_lib

    # the bf16 mode at the same levels: one bf16 pass on the tensor cores
    # (bound at the dense bf16 rate), bf16 operands and outputs; within one
    # bf16 ulp of the largest entry (forward) and two (backward) of the
    # plain version at the Pallas kernels' rounding points
    for T_, hd in ((1024, 64), (256, 128), (64, 128)):
        q, k, v, do = (torch.randn((32, T_, hd), generator=g).to(dev)
                       .bfloat16() for _ in range(4))
        scale = 1.0 / math.sqrt(hd)
        compare('attention_bf16', f'attention bf16 G=32 T={T_} hd={hd}',
                lambda: k_attn.attention(q, k, v, scale),
                lambda: k_attn.attention_plain(q, k, v, scale), 2.0 ** -7,
                32 * T_ * T_ * 4, 4 * nbytes(q), relative=True,
                library=lambda: sdpa(q, k, v, scale),
                tensor_flops=32 * T_ * T_ * 4 * hd,
                tensor_rate=PEAK_BF16_FLOPS, passes=1)
        _, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out_lib = sdpa(*leaves, scale)
        compare('attention_bwd_bf16',
                f'attention backward bf16 G=32 T={T_} hd={hd}',
                lambda: k_attn.attention_backward(q, k, v, o32, lse, do,
                                                  scale),
                lambda: k_attn.attention_backward_plain(q, k, v, do, scale),
                2.0 ** -6, 32 * T_ * T_ * 8,
                nbytes(q, k, v, o32, lse, do) + 3 * nbytes(q), relative=True,
                library=lambda: torch.autograd.grad(out_lib, leaves, do,
                                                    retain_graph=True),
                tensor_flops=32 * T_ * T_ * 10 * hd,
                tensor_rate=PEAK_BF16_FLOPS, passes=1)
        del leaves, out_lib

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
    n_b = S * n_rays * K
    compare('decode', f'decode colour S={S} M={n_rays * K} (per-ray, K={K})',
            lambda: k_dec.triplane_decode(planes, xyz_b, params, hidden,
                                          rid_b, dir_b),
            lambda: k_dec.triplane_decode_plain(planes, xyz_b, params,
                                                hidden, rid_b, dir_b), 1e-5,
            n_b * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes, xyz_b, params, rid_b, dir_b) + n_b * 16,
            tensor_flops=3 * n_b * decode_products(C, hidden))
    compare('decode_bf16', f'decode bf16 colour S={S} M={n_rays * K} '
            f'(per-ray, K={K})',
            lambda: k_dec.triplane_decode(planes_b, xyz_b, params_b, hidden,
                                          rid_b, dir_b),
            lambda: k_dec.triplane_decode_plain(planes_b, xyz_b, params_b,
                                                hidden, rid_b, dir_b),
            2.0 ** -8,
            n_b * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes_b, xyz_b, params, rid_b, dir_b) + n_b * 16,
            relative=True, tensor_flops=n_b * decode_products(C, hidden),
            passes=1,
            f32_plain=lambda: k_dec.triplane_decode_plain(
                planes_f, xyz_b, params_b, hidden, rid_b, dir_b))
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
            1e-5, 3 * n_b * (decode_flops(C, hidden)
                             - decode_products(C, hidden)),
            nbytes(planes, xyz_b, params, rid_b, dir_b, g_sig, g_rgb)
            + nbytes(planes, params, dir_b), relative=True,
            tensor_flops=9 * n_b * decode_products(C, hidden))
    # bf16: the plane gradient comes back bf16; two ulps of each
    # gradient's largest entry (f32 atomics in a run-dependent order, and
    # roundings that fall the other way after them), the mean and the gap
    # as the forward's
    compare('decode_bwd_bf16', f'decode backward bf16 S={S} '
            f'M={n_rays * K} (per-ray, K={K})',
            lambda: k_dec.triplane_decode_backward(
                planes_b, xyz_b, params_b, hidden, rid_b, dir_b, g_sig,
                g_rgb),
            lambda: k_dec.triplane_decode_backward_plain(
                planes_b, xyz_b, params_b, hidden, rid_b, dir_b, g_sig,
                g_rgb),
            2.0 ** -6, 3 * n_b * (decode_flops(C, hidden)
                                  - decode_products(C, hidden)),
            nbytes(planes_b, xyz_b, params, rid_b, dir_b, g_sig, g_rgb)
            + nbytes(planes_b, params, dir_b), relative=True,
            tensor_flops=3 * n_b * decode_products(C, hidden), passes=1,
            f32_plain=lambda: k_dec.triplane_decode_backward_plain(
                planes_f, xyz_b, params_b, hidden, rid_b, dir_b, g_sig,
                g_rgb))

    # the render variants' kernels on the packed layouts of a coherent
    # render: the ball from BALL_VIEWS, 4 x 128^2 rays a scene, P=512 (4096
    # groups a scene).  Work and slot bytes are counted on valid slots.
    dec = TriPlaneDecoder(compact_steps=64, march_slots=128, pack_slots=512)
    lay = ball_layouts(dec, S, H, res, dev)
    check(lay['ok'], 'phase 2: the banded guard does not hold on the ball')
    n_rays = 4 * 128 * 128
    dir_l = (torch.randn((S, n_rays, hidden), generator=g) * 0.3).to(dev)
    n_valid = int(lay['pvalid'].sum())
    check(n_valid == int(lay['pvalid_b'].sum()), 'band layout sample count')
    M_l = lay['xyz'].shape[1]
    # the decode forward on the ray layout's slots, as the split render
    # decodes them: coherent rays, every slot (valid or not) decoded
    n_l = S * M_l
    compare('decode', f'decode colour S={S} M={M_l} (packed ball layout, '
            f'P=512, valid {n_valid})',
            lambda: k_dec.triplane_decode(planes, lay['xyz'], params, hidden,
                                          lay['rid'], dir_l),
            lambda: k_dec.triplane_decode_plain(planes, lay['xyz'], params,
                                                hidden, lay['rid'], dir_l),
            1e-5, n_l * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes, lay['xyz'], params, lay['rid'], dir_l) + n_l * 16,
            tensor_flops=3 * n_l * decode_products(C, hidden))
    compare('decode_bf16', f'decode bf16 colour S={S} M={M_l} (packed ball '
            f'layout, P=512, valid {n_valid})',
            lambda: k_dec.triplane_decode(planes_b, lay['xyz'], params_b,
                                          hidden, lay['rid'], dir_l),
            lambda: k_dec.triplane_decode_plain(planes_b, lay['xyz'],
                                                params_b, hidden, lay['rid'],
                                                dir_l),
            2.0 ** -8,
            n_l * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes_b, lay['xyz'], params, lay['rid'], dir_l)
            + n_l * 16, relative=True,
            tensor_flops=n_l * decode_products(C, hidden), passes=1,
            f32_plain=lambda: k_dec.triplane_decode_plain(
                planes_f, lay['xyz'], params_b, hidden, lay['rid'], dir_l))
    comp = (planes, lay['xyz'], params, hidden, lay['rid'], dir_l, lay['pt'],
            lay['pdt'], lay['pvalid'], lay['soffs'], GROUP_RAYS, 0.001, 1e-4)
    # tolerances: weights_sum, depth (sums of w t, t ~ 2), image
    compare('decode_composite', f'decode+composite S={S} slots={M_l} '
            f'(valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_composite(*comp),
            lambda: k_dec.triplane_decode_composite_plain(*comp),
            (1e-5, 5e-5, 1e-5), n_valid * (decode_flops(C, hidden) + 40),
            nbytes(planes, params, dir_l, lay['soffs'], lay['pvalid'])
            + n_valid * 24 + S * n_rays * 20)
    band = (planes, lay['xyz_b'], params, hidden, lay['rid_b'], dir_l,
            lay['win'])
    compare('decode_banded', f'decode banded S={S} slots={M_l} '
            f'(valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_banded(*band),
            lambda: k_dec.triplane_decode_banded_plain(*band), 1e-5,
            n_valid * decode_flops(C, hidden),
            nbytes(planes, params, dir_l, lay['win']) + n_valid * 32)
    # the variants in bf16: per-ray sums (composite) and raw outputs
    # (banded), held as the bf16 decode forward
    comp_b = (planes_b, comp[1], params_b) + comp[3:]
    compare('decode_composite_bf16', f'decode+composite bf16 S={S} '
            f'slots={M_l} (valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_composite(*comp_b),
            lambda: k_dec.triplane_decode_composite_plain(*comp_b),
            2.0 ** -8, n_valid * (decode_flops(C, hidden) + 40),
            nbytes(planes_b, params, dir_l, lay['soffs'], lay['pvalid'])
            + n_valid * 24 + S * n_rays * 20, relative=True,
            f32_plain=lambda: k_dec.triplane_decode_composite_plain(
                planes_f, *comp_b[1:]))
    band_b = (planes_b, band[1], params_b) + band[3:]
    compare('decode_banded_bf16', f'decode banded bf16 S={S} slots={M_l} '
            f'(valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_banded(*band_b),
            lambda: k_dec.triplane_decode_banded_plain(*band_b), 2.0 ** -8,
            n_valid * decode_flops(C, hidden),
            nbytes(planes_b, params, dir_l, lay['win']) + n_valid * 32,
            relative=True,
            f32_plain=lambda: k_dec.triplane_decode_banded_plain(
                planes_f, *band_b[1:]))
    return results, lib_kernels


def phase_probe(dev):
    """The probe tool's path once (``python -m
    ssdnerf_torch.tools.march_scalar_probe``: its draws, the counts held
    exactly against the plain version, both timings); its kernel must have
    launched."""
    reset_launches()
    res = march_scalar_probe.run(dev)
    launches = {n: launch_counts()[n] for n in PROBE}
    log(f'phase 2 probe: march_popcount {res["popcount_ms"]:.4f} ms = '
        f'{res["popcount_ns"]:.4f} ns/sample, march_valid_mask '
        f'{res["march_ms"]:.4f} ms = {res["march_ns"]:.4f} ns/sample '
        f'({res["samples"]} samples; ratio {res["ratio"]:.4f}); launches '
        f'{launches}')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched by the probe')
    return launches, res


def make_model(seed, config=CONFIG):
    """Flagship model (or ``config``'s) with seeded random weights on the CPU: the JAX
    package's init plus N(0, 0.02) on every parameter (the init zeroes
    proj / conv_2 / out_conv / dir_net, which would hide attention and
    the direction branch).  The density bias is lowered by 3 so that part
    of every density grid is empty, as in a real scene: with random
    weights every voxel would otherwise be occupied and the march would
    test nothing."""
    model = init_model(Config.fromfile(str(config)), 'cpu', seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in list(model.decoder.parameters()) + list(
                model.diffusion.parameters()):
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        model.decoder.density_net.dense_0.bias -= 3.0
    model.reset_ema()
    return model


def phase_slice(model, dev, phase=3, label='', kernels=SERVING):
    """val_uncond (as its two halves, timed apart) + render at flagship
    width on the card; each of ``kernels`` must launch."""
    S, V, h, w = 8, 4, 128, 128
    tcfg = model.test_cfg
    g = torch.Generator().manual_seed(SEED + 2)
    noise = torch.randn((S,) + model.code_size, generator=g).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    poses, intr = orbit_cameras(S, V, dev)
    reset_launches()
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
    launches = launch_counts()
    log(f'phase {phase} slice{label}: DDIM {tcfg["num_timesteps"]} steps x {S} scenes '
        f'{t1 - t0:.3f} s; density rebuild {tcfg.get("density_step", 8)} '
        f'sweeps {t2 - t1:.3f} s; render {S}x{V}x{h}x{w} {t3 - t2:.3f} s; '
        f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    sat = model.decoder.sigmoid_saturation
    occ = np.unpackbits(bitfield.cpu().numpy()).mean()
    log(f'phase {phase} outputs{label}: code {tuple(code.shape)} |code|max='
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
    for name in kernels:
        check(launches[name] > 0, f'kernel {name} was not launched by the '
              'slice')
    return launches, code, bitfield, dict(ddim_s=t1 - t0, density_s=t2 - t1,
                                          render_s=t3 - t2)


def render_decoder(model, **fields):
    """The EMA decoder as ``MultiSceneNeRF.render`` uses it (test_cfg's
    ``march_slots`` / ``pack_slots``), with the decoder ``fields`` set: a
    shallow copy that shares the parameters."""
    dec = copy.copy(model.ema_decoder)
    for key in ('march_slots', 'pack_slots'):
        if key in model.test_cfg:
            setattr(dec, key, model.test_cfg[key])
    for key, value in fields.items():
        setattr(dec, key, value)
    return dec


def render_outputs(model, decoder, code, bitfield, poses, intr):
    """``volume_render`` of ``decoder`` on the 128x128 rays of ``poses``, as
    ``render_views`` calls it (test_cfg's dt_gamma): weights_sum, depth
    and image before the background blend."""
    S = code.shape[0]
    rays_o, rays_d = get_cam_rays(poses, intr, 128, 128)
    dt_gamma = model.test_cfg.get('dt_gamma_scale', 0.0) * 2 / (
        intr[..., 0] + intr[..., 1]).mean(dim=-1)
    with torch.no_grad():
        return volume_render(decoder, code, rays_o.reshape(S, -1, 3),
                             rays_d.reshape(S, -1, 3), bitfield,
                             model.grid_size, dt_gamma=dt_gamma)


def phase_variants(model, code, bitfield, dev):
    """The render variants of the phase-3 scenes: the generated scenes from
    the orbit views, and the same codes over the ball from BALL_VIEWS
    (4 x 128^2 rays a scene each), rendered split, with
    ``fused_composite`` and with ``banded_decode`` (bf16 decode, as
    shipped); each variant against the split render of the same scene
    within 2^-8 of the largest entry and a mean within 1e-5 of it
    (:func:`bf16_errors`: three kernels, each rounding to bf16 after its
    own f32 sums).  The second of two renders of each is timed."""
    S = code.shape[0]
    reset_launches()
    volume_render.banded_engaged = volume_render.banded_declined = 0
    scenes = {'generated, orbit views': (bitfield,) + orbit_cameras(S, 4,
                                                                     dev),
              'ball, look-at views': (ball_bitfield(S, model.grid_size, dev),)
              + look_at_views(S, BALL_VIEWS, dev)}
    walls, guards = {}, {}
    for scene, (bf, poses, intr) in scenes.items():
        outs = {}
        for variant in ('split', 'fused_composite', 'banded_decode'):
            dec = render_decoder(model, **({} if variant == 'split'
                                           else {variant: True}))
            engaged = volume_render.banded_engaged
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[variant] = render_outputs(model, dec, code, bf, poses,
                                               intr)
                torch.cuda.synchronize()
            walls[f'{scene}: {variant}'] = time.perf_counter() - t0
            if variant == 'banded_decode':
                guards[scene] = ('engaged' if volume_render.banded_engaged
                                 - engaged == 2 else 'declined')
        split = outs['split']
        for k, t in split.items():
            check(torch.isfinite(t).all().item(), f'{scene}: {k} not finite')
        check(split['weights_sum'].max().item() > 0.05,
              f'{scene}: renders empty')
        for variant in VARIANTS.values():
            errs = {k: bf16_errors(outs[variant][k], split[k])
                    for k in ('weights_sum', 'depth', 'image')}
            log(f'phase 3 variant {variant} vs split ({scene}): '
                + ' '.join(f'{k} max/mean rel_err={e[0]:.3e}/{e[1]:.3e} '
                           f'(share > 1e-5: {e[2]:.2e})'
                           for k, e in errs.items())
                + ' (tol 2^-8 / 1e-5)')
            check(all(e[0] <= 2.0 ** -8 and e[1] <= 1e-5
                      for e in errs.values()), f'{scene}: {variant} vs split')
        log(f'phase 3 render {S}x4x128x128 ({scene}): ' + ', '.join(
            f'{v} {walls[f"{scene}: {v}"]:.4f} s'
            for v in ('split', 'fused_composite', 'banded_decode'))
            + f'; banded guard {guards[scene]}')
    # where each variant's render time goes, on the ball (guard engaged)
    profiles = {}
    bf, poses, intr = scenes['ball, look-at views']
    for variant in ('split', 'fused_composite', 'banded_decode'):
        dec = render_decoder(model, **({} if variant == 'split'
                                       else {variant: True}))
        wall_ms, dev_ms, _, groups, _ = profile_step(
            lambda: render_outputs(model, dec, code, bf, poses, intr),
            ranges=(), group_of=render_group)
        ports = {k: v for k, v in groups.items() if k in WRAPPERS}
        top = sorted((kv for kv in groups.items() if kv[0] not in WRAPPERS),
                     key=lambda kv: -kv[1])[:8]
        log(f'phase 3 profiled render ({variant}, ball): wall {wall_ms:.1f} '
            f'ms, device {dev_ms:.1f} ms; kernels: ' + ', '.join(
                f'{k} {v:.2f}' for k, v in ports.items())
            + '; top torch ops: ' + ', '.join(f'{k} {v:.2f}'
                                              for k, v in top))
        profiles[variant] = dict(wall_ms=wall_ms, device_ms=dev_ms,
                                 kernels_ms=ports, top_ops_ms=dict(top))
    launches = {n: launch_counts()[n] for n in VARIANTS}
    log(f'phase 3 variants: launches {launches}; guard {guards}')
    check(guards['ball, look-at views'] == 'engaged',
          'the banded guard did not engage on the ball')
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched by the variant renders')
    return launches, dict(render_s=walls, banded_guard=guards,
                          profiled_render=profiles)


def phase_variants_card_vs_cpu(model_cpu, model_dev, code, dev):
    """One scene, one ball view at 128x128: each render variant on the card
    against the CPU's plain versions, same weights and code, in bf16 (as
    shipped) and with ``compute_dtype`` 'float32', both at phase 4's f32
    image limits: here the fused composite's own f32 differences (its
    transmittance cut, ~1e-3 at the most) exceed the CPU's bf16-vs-f32 gap
    (~3e-6 relative L2 on an H100), so the gap cannot set the bf16
    limit.  Returns the launches of the f32 renders on the card (counts
    set to 0 just before them)."""
    bf = ball_bitfield(1, model_cpu.grid_size, 'cpu')
    poses, intr = look_at_views(1, BALL_VIEWS[:1], 'cpu')
    code = code[:1].cpu()
    imgs, guard = {}, {}
    for dtype in ('bfloat16', 'float32'):
        if dtype == 'float32':
            reset_launches()
        for variant in VARIANTS.values():
            for tag, model, d in (('card', model_dev, dev),
                                  ('cpu', model_cpu, 'cpu')):
                engaged = volume_render.banded_engaged
                with decode_dtype(model, dtype):
                    out = render_outputs(
                        model, render_decoder(model, **{variant: True}),
                        code.to(d), bf.to(d), poses.to(d), intr.to(d))
                imgs[variant, dtype, tag] = (
                    out['image'] + model.bg_color
                    * (1 - out['weights_sum'][..., None])).cpu()
                guard[variant, dtype, tag] = (volume_render.banded_engaged
                                              - engaged)
    f32_launches = launch_counts()
    for variant in VARIANTS.values():
        img = {k[1:]: v for k, v in imgs.items() if k[0] == variant}
        ok = image_card_vs_cpu(f'phase 4 {variant}', img, gap_rule=False)
        if variant == 'banded_decode':
            log(f'phase 4 {variant}: banded guard engaged card/cpu '
                + ', '.join(f'{dt} {guard[variant, dt, "card"]}/'
                            f'{guard[variant, dt, "cpu"]}'
                            for dt in ('bfloat16', 'float32')))
            check(all(guard[variant, dt, t] == 1 for dt in
                      ('bfloat16', 'float32') for t in ('card', 'cpu')),
                  'card vs cpu: banded guard')
        check(ok, f'card vs cpu: {variant} image')
    return f32_launches


def image_card_vs_cpu(what, img, gap_rule=True):
    """Images ``img[(dtype, 'card' | 'cpu')]``: f32 max |card - cpu| <=
    2e-2 and mean <= 1e-3; bf16 (the bf16 decode) with ``gap_rule``
    within half the CPU's bf16-vs-f32 gap of the CPU's bf16 image
    (relative L2) and at least half that gap away from its f32 image, else
    at the f32 limits.  Logs and returns whether they hold."""
    diffs = {dt: (img[dt, 'card'] - img[dt, 'cpu']).abs()
             for dt in ('float32', 'bfloat16')}
    err = l2(img['bfloat16', 'card'], img['bfloat16', 'cpu'])
    gap = l2(img['bfloat16', 'cpu'], img['float32', 'cpu'])
    far = l2(img['bfloat16', 'card'], img['float32', 'cpu'])
    log(f'{what} card vs cpu: ' + '; '.join(
        f'{dt} image max_abs_err={d.max().item():.3e} mean='
        f'{d.mean().item():.3e}' for dt, d in diffs.items())
        + ' (f32 tol 2e-2 / 1e-3); bf16 image rel_l2 '
        f'{err:.3e}, bf16-vs-f32 gap on the cpu {gap:.3e}, card from f32 '
        f'{far:.3e}' + (' (tol <= 0.5 x gap, >= 0.5 x gap)' if gap_rule
                        else ' (bf16 at the f32 tol)'))
    f32_ok = [d.max().item() <= 2e-2 and d.mean().item() <= 1e-3
              for d in diffs.values()]
    if gap_rule:
        return f32_ok[0] and err <= 0.5 * gap and far >= 0.5 * gap
    return all(f32_ok)


def phase_card_vs_cpu(model_cpu, model_dev, dev):
    """1 scene, 2 DDIM steps, 1 density sweep, 1 view: the card against
    the CPU's plain versions, same weights, noise and jitter; the density
    sweep and the view in bf16 (as shipped) and again with
    ``compute_dtype`` 'float32', from the same codes.  f32 tolerances:
    density max rel 5e-3, image as :func:`image_card_vs_cpu`; bf16: the
    density grid and the image within half the CPU's bf16-vs-f32 gap of
    the CPU's bf16 ones (relative L2) and at least half that gap from its
    f32 ones; codes 1e-3 and flipped bits <= 1e-3 in both.  Returns the
    launches of the f32 sweep and render on the card (counts set to 0
    just before them)."""
    cfg = dict(model_cpu.test_cfg, num_timesteps=2, density_step=1)
    g = torch.Generator().manual_seed(SEED + 4)
    noise = torch.randn((1,) + model_cpu.code_size, generator=g)
    jitter = density_jitter(model_cpu.grid_size, model_cpu.decoder.bound, 1,
                            g, 'cpu')
    poses, intr = orbit_cameras(1, 1, 'cpu')
    outs, codes = {}, {}
    for tag, model, d in (('card', model_dev, dev), ('cpu', model_cpu,
                                                     'cpu')):
        t0 = time.perf_counter()
        saved, model.test_cfg = model.test_cfg, cfg
        try:
            code = model.sample_codes(noise.to(d))
            codes[tag] = code.cpu()
            for dtype in ('bfloat16', 'float32'):
                if tag == 'card' and dtype == 'float32':
                    reset_launches()
                with decode_dtype(model, dtype):
                    grid, bitfield = model.rebuild_density(
                        code, jitter=jitter.to(d))
                    img, _ = model.render(code, bitfield, 128, 128,
                                          intr.to(d), poses.to(d))
                if tag == 'card' and dtype == 'float32':
                    f32_launches = launch_counts()
                outs[dtype, tag] = [t.cpu() for t in (grid, bitfield, img)]
        finally:
            model.test_cfg = saved
        log(f'phase 4 {tag}: {time.perf_counter() - t0:.2f} s')
    code_err = (codes['card'] - codes['cpu']).abs().max().item()
    flips = {dt: (np.unpackbits(outs[dt, 'card'][1].numpy())
                  != np.unpackbits(outs[dt, 'cpu'][1].numpy())).mean()
             for dt in ('bfloat16', 'float32')}
    g1, g0 = (outs['float32', t][0].float() for t in ('card', 'cpu'))
    grid_rel = ((g1 - g0).abs() / (g0.abs() + 1e-3)).max().item()
    grid = {t: outs['bfloat16', t][0].float() for t in ('card', 'cpu')}
    gerr, ggap, gfar = (l2(grid['card'], grid['cpu']),
                        l2(grid['cpu'], outs['float32', 'cpu'][0].float()),
                        l2(grid['card'], outs['float32', 'cpu'][0].float()))
    log(f'phase 4 card vs cpu: code max_abs_err={code_err:.3e} (tol 1e-3); '
        f'f32 density max_rel_err={grid_rel:.3e} (tol 5e-3); bf16 density '
        f'rel_l2 {gerr:.3e} (tol 0.5 x gap {ggap:.3e}), card from f32 '
        f'{gfar:.3e} (tol >= 0.5 x gap); bitfield flipped share bf16 '
        f'{flips["bfloat16"]:.2e} f32 {flips["float32"]:.2e} (tol 1e-3)')
    check(code_err <= 1e-3, 'card vs cpu: codes')
    check(grid_rel <= 5e-3, 'card vs cpu: f32 density grid')
    check(gerr <= 0.5 * ggap and gfar >= 0.5 * ggap,
          'card vs cpu: bf16 density grid')
    check(max(flips.values()) <= 1e-3, 'card vs cpu: bitfield')
    check(image_card_vs_cpu('phase 4 slice', {k: v[2] for k, v in
                                              outs.items()}),
          'card vs cpu: image')
    return f32_launches


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
    """The group of a device kernel launched under profiler ``event`` (None
    for none): the port's kernels by name, the rest by the op that
    launched them."""
    for group, key in PORT_KERNELS:
        if re.search(key, name):
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


def render_group(name, event):
    """The group of a device kernel of a render: the port's kernels by
    name, the rest by the torch op that launched them."""
    for group, key in PORT_KERNELS:
        if re.search(key, name):
            return group
    return 'no torch op' if event is None else event.name


def profile_step(run, ranges=TRAIN_PARTS, group_of=kernel_group):
    """Runs ``run`` once under ``torch.profiler`` and splits the device
    time of what it launched (kernels, memcpy, memset), each counted once
    under the op that launched it: by the profiler range of ``ranges``
    whose host span holds the launch (autograd's backward thread launches
    inside the span of the ``autograd.grad`` call), and by ``group_of``.
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
             if e.name in ranges]
    check(len(spans) == len(ranges), f'profile: ranges {spans}')
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
            group = group_of(k.name, e)
            groups[group] = groups.get(group, 0.0) + ms
            n, t = kernels.get(k.name, (0, 0.0))
            kernels[k.name] = (n + 1, t + ms)
    # a kernel launched outside any torch op (a port kernel called without
    # autograd) is linked to no CPU event: count it from the trace's
    # device events, under a part of its own
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in annotations:
            n, t = device.get(e.name, (0, 0.0))
            device[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, ms) in device.items():
        n0, ms0 = kernels.get(name, (0, 0.0))
        if n > n0:
            parts['no torch op'] = parts.get('no torch op', 0.0) + ms - ms0
            group = group_of(name, None)
            groups[group] = groups.get(group, 0.0) + ms - ms0
            kernels[name] = (n, ms)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return wall_ms, sum(parts.values()), parts, groups, top


def phase_train(model, cfg, data, code, dev, timed=4, phase=5,
                required=None):
    """Flagship train steps of the 8 scenes of ``data``, scene state in a
    device bank of ``cache_size`` rows: one warm-up step, ``timed`` steps
    timed on the host clock to a device synchronise, and one step under
    the profiler.  The bank starts from the scenes' codes, as the config's
    ``cache_load_from`` resumes from a saved code cache; density grids
    start empty.  Each kernel of ``required`` (default: those of the
    flagship's train step, TRAIN) must launch, and its group must read
    device time in the profiled step."""
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

    reset_launches()
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
        log(f'phase {phase} step {i}{" (warm-up)" if i == 0 else ""}'
            f'{" (profiled)" if i == steps - 1 else ""}: {dt:.4f} s; '
            + ' '.join(f'{k}={v:.5g}' for k, v in sorted(vals.items())))
        for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                  'reg_loss'):
            check(math.isfinite(vals[k]), f'train step {i}: {k} not finite')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = statistics.median(times)
    log(f'phase {phase} step time: median {median:.4f} s over steps 1-{timed} '
        f'(min {min(times):.4f}, max {max(times):.4f})')
    log(f'phase {phase} profiled step: wall {wall_ms:.1f} ms, device {dev_ms:.1f} '
        f'ms = {dev_ms / 1e3 / median:.3f} of the median step; by part: '
        + ', '.join(f'{k} {v:.1f} ms' for k, v in parts.items()))
    log(f'phase {phase} device time by group: ' + ', '.join(
        f'{k} {v:.1f} ms ({v / dev_ms:.1%})'
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, (n, ms) in top:
        log(f'phase {phase} kernel {ms:8.2f} ms x{n:4d} {name[:90]}')
    norm = model.diffusion.norm_factor.item()
    occ = np.unpackbits(bank.density_bitfield[:S].cpu().numpy()).mean()
    moved = (bank.code_[:S] - code0).abs().max().item()
    counters = bank.step[:S].tolist()
    log(f'phase {phase} train: {S} scenes, extra_scene_step {ess}, bank '
        f'{bank.cache_size} scenes; peak memory {peak:.2f} GiB; '
        f'norm_factor {norm:.6f}; occupancy {occ:.4f}; codes moved '
        f'{moved:.3e}; Adam steps {counters}; launches {launches}')
    check(math.isfinite(norm) and norm != 1.0, 'norm_factor')
    check(moved > 0, 'codes did not move')
    check(counters == [steps * (ess + 1)] * S, 'Adam step counters')
    check(0.0 < occ < 1.0, 'density grids entirely empty or full')
    for name in required or TRAIN:
        check(launches[name] > 0,
              f'kernel {name} was not launched by the train steps')
        check(groups.get(name, 0.0) > 0, f'kernel {name} read no device '
              'time in the profiled step')
    return launches, dict(step_s=times, median_step_s=median,
                          profiled_wall_ms=wall_ms, device_ms=dev_ms,
                          device_ms_by_part=parts, device_ms_by_group=groups,
                          peak_gib=peak)


def module_grads(module):
    return torch.cat([p.grad.reshape(-1) for p in module.parameters()])


def phase_train_card_vs_cpu(model_cpu, cfg, data, code, dev):
    """One train step of scene 0 with 1 inner step and 1024 rays, on the
    card and on the CPU, from the same weights, codes and draws, in bf16
    (the decode as shipped) and with ``compute_dtype`` 'float32'.  f32:
    losses rel 1e-4, gradients (max |card - cpu| / max |cpu| over each
    whole module) 1e-3; bf16: each limit, or half the CPU's bf16-vs-f32
    gap of the same quantity where that is larger (the UNet's gradient
    and the diffusion loss do not depend on the decode, so their gap is
    ~0 and the f32 limit holds).  Returns the launches of the f32 step on
    the card (counts set to 0 just before it)."""
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
    for dtype in ('bfloat16', 'float32'):
        for tag, d in (('card', dev), ('cpu', 'cpu')):
            model = copy.deepcopy(model_cpu).to(d)
            opts, scheds = build_optimizers(model, cfg.optimizer,
                                            cfg.lr_config)
            batch_d = to_device(batch, d)
            batch_d['opt'] = adam_init(batch_d['code_'])
            if tag == 'card' and dtype == 'float32':
                reset_launches()
            t0 = time.perf_counter()
            with decode_dtype(model, dtype):
                out, logs = model.train_step(batch_d, to_device(data, d),
                                             opts, scheds,
                                             draws=to_device(draws, d))
            if tag == 'card' and dtype == 'float32':
                f32_launches = launch_counts()
            outs[dtype, tag] = dict(
                logs={k: v.item() for k, v in logs.items()},
                code_m=out['opt'].m.cpu(),
                bits=out['density_bitfield'].cpu(),
                unet=module_grads(model.diffusion).cpu(),
                decoder=module_grads(model.decoder).cpu())
            log(f'phase 6 {tag} ({dtype}): {time.perf_counter() - t0:.2f} s')
            del model

    def rel(a, b, k):
        if k in a.get('logs', {}):
            return abs(a['logs'][k] - b['logs'][k]) / abs(b['logs'][k])
        return ((a[k] - b[k]).abs().max() / b[k].abs().max()).item()

    for dtype in ('bfloat16', 'float32'):
        card, cpu = outs[dtype, 'card'], outs[dtype, 'cpu']
        flips = (np.unpackbits(card['bits'].numpy())
                 != np.unpackbits(cpu['bits'].numpy())).mean()
        log(f'phase 6 card vs cpu ({dtype}): bitfield flipped share '
            f'{flips:.2e}')
        # gradients: the codes' through the Adam first moment m (zero
        # before the step, so m is a fixed combination of this step's two
        # code gradients)
        for k, f32_tol in (('loss_diffusion', 1e-4), ('loss_decoder', 1e-4),
                           ('pixel_loss', 1e-4), ('reg_loss', 1e-4),
                           ('code_m', 1e-3), ('unet', 1e-3),
                           ('decoder', 1e-3)):
            err = rel(card, cpu, k)
            tol, gap = f32_tol, 0.0
            if dtype == 'bfloat16':
                gap = rel(cpu, outs['float32', 'cpu'], k)
                tol = max(f32_tol, 0.5 * gap)
            log(f'phase 6 {k} ({dtype}): rel_err {err:.2e} (tol {tol:.2e}'
                + (f'; bf16-vs-f32 gap on the cpu {gap:.2e}'
                   if dtype == 'bfloat16' else '') + ')')
            check(err <= tol, f'card vs cpu ({dtype}): {k}')
    return f32_launches


def l2(a, b):
    """||a - b|| / ||b|| over whole tensors, in f64 on the CPU."""
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def phase_bf16_slice(model_bf16, model_f32, dev, f32_times):
    """Generation with the bf16 configuration at batch 8 (phase 3's
    slice), then the flagship's DDIM under ``use_fp16`` (bf16 autocast),
    from phase 3's noise; wall seconds beside phase 3's f32 ones.  The
    bf16 attention must launch in both."""
    launches, code, _, times = phase_slice(
        model_bf16, dev, phase=7, label=' (bf16 config)',
        kernels=('march', 'decode_bf16', 'attention_bf16'))
    noise = torch.randn((8,) + model_f32.code_size,
                        generator=torch.Generator().manual_seed(SEED + 2)
                        ).to(dev)
    model_f32.autocast_dtype = 'bfloat16'
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    code16 = model_f32.sample_codes(noise)
    torch.cuda.synchronize()
    fp16_s = time.perf_counter() - t0
    model_f32.autocast_dtype = None
    fp16_launches = launch_counts()
    log(f'phase 7 use_fp16 flagship DDIM {model_f32.test_cfg["num_timesteps"]}'
        f' steps x 8 scenes {fp16_s:.3f} s; launches {fp16_launches}')
    log(f'phase 7 generation wall s, f32 / bf16 config / use_fp16: DDIM '
        f'{f32_times["ddim_s"]:.3f} / {times["ddim_s"]:.3f} / {fp16_s:.3f}; '
        f'density {f32_times["density_s"]:.3f} / {times["density_s"]:.3f}; '
        f'render {f32_times["render_s"]:.3f} / {times["render_s"]:.3f}')
    check(torch.isfinite(code16).all().item() and code16.shape == code.shape,
          'use_fp16 codes')
    check(fp16_launches['attention_bf16'] > 0,
          'the bf16 attention was not launched under use_fp16')
    return launches, dict(bf16_config=times, use_fp16_ddim_s=fp16_s,
                          use_fp16_launches=fp16_launches)


def phase_bf16_card_vs_cpu(model_cpu, model_bf16_cpu, model_dev,
                           model_bf16_dev):
    """1 scene, 2 DDIM steps in both bf16 modes (the bf16 configuration;
    the flagship under autocast), on the card and on the CPU with the same
    weights and noise.  Tolerance (PERF.md): the card's codes within 1.25
    x the CPU's bf16-vs-f32 gap of the CPU's bf16 codes (relative L2) and
    at least half that gap away from the f32 codes."""
    cfg = dict(model_cpu.test_cfg, num_timesteps=2)
    noise = torch.randn((1,) + model_cpu.code_size,
                        generator=torch.Generator().manual_seed(SEED + 7))

    def codes(model, d, autocast=False):
        saved, model.test_cfg = model.test_cfg, cfg
        model.autocast_dtype = 'bfloat16' if autocast else None
        try:
            return model.sample_codes(noise.to(d)).cpu()
        finally:
            model.test_cfg, model.autocast_dtype = saved, None

    f32 = codes(model_cpu, 'cpu')
    out = {}
    for mode, cpu_model, dev_model, autocast in (
            ('bf16 config', model_bf16_cpu, model_bf16_dev, False),
            ('use_fp16', model_cpu, model_dev, True)):
        card = codes(dev_model, next(dev_model.parameters()).device,
                     autocast)
        cpu = codes(cpu_model, 'cpu', autocast)
        err, gap, far = l2(card, cpu), l2(cpu, f32), l2(card, f32)
        log(f'phase 7 card vs cpu ({mode}, 2 DDIM steps, 1 scene): codes '
            f'rel_l2 {err:.3e} (tol 1.25 x gap {gap:.3e}); card from f32 '
            f'{far:.3e} (tol >= 0.5 x gap)')
        check(err <= 1.25 * gap and far >= 0.5 * gap,
              f'card vs cpu bf16: {mode}')
        out[mode] = dict(rel_l2=err, gap=gap, from_f32=far)
    return out


def phase_unet_precision(unet_f32, unet_bf16, dev):
    """Device ms of one flagship UNet forward at batch 8 in IEEE f32, TF32
    (the switches flipped here only, in place of the UNet's pin), f32
    channels-last and bf16: the profiler's device time a call (mean of 3
    after a warm-up)."""
    from ssdnerf_torch.models.architecture import unet as unet_mod
    g = torch.Generator().manual_seed(SEED + 8)
    x = torch.randn((8, unet_f32.in_channels, 128, 128), generator=g).to(dev)
    t = torch.randint(0, unet_f32.num_timesteps, (8,), generator=g).to(dev)
    ms = {}

    def run(unet, inp):
        with torch.no_grad():
            return unet(inp, t)

    ms['ieee_f32'] = sum(device_profile(lambda: run(unet_f32, x), 3).values())
    pinned = unet_mod.precision

    @contextlib.contextmanager
    def tf32():
        cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = cudnn.allow_tf32, mm.allow_tf32
        cudnn.allow_tf32 = mm.allow_tf32 = True
        try:
            yield
        finally:
            cudnn.allow_tf32, mm.allow_tf32 = saved

    unet_mod.precision = tf32
    try:
        ms['tf32'] = sum(device_profile(lambda: run(unet_f32, x), 3).values())
    finally:
        unet_mod.precision = pinned
    unet_cl = copy.deepcopy(unet_f32).to(memory_format=torch.channels_last)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    ms['f32_channels_last'] = sum(device_profile(
        lambda: run(unet_cl, x_cl), 3).values())
    del unet_cl
    ms['bf16'] = sum(device_profile(lambda: run(unet_bf16, x), 3).values())
    out = run(unet_bf16, x)
    check(torch.isfinite(out).all().item(), 'bf16 UNet output')
    log('phase 7 UNet forward (flagship, batch 8) device ms: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in ms.items()))
    return ms


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

    kernels, lib_kernels = phase_kernels(dev)
    probe_launches, probe = phase_probe(dev)
    cfg = Config.fromfile(str(CONFIG))
    model_cpu = make_model(SEED)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    serve_launches, code, bitfield, times = phase_slice(model_dev, dev)
    variant_launches, variants = phase_variants(model_dev, code, bitfield,
                                                dev)
    f32_render_launches = phase_card_vs_cpu(model_cpu, model_dev, dev)
    f32_variant_launches = phase_variants_card_vs_cpu(model_cpu, model_dev,
                                                      code, dev)
    f32_render_launches.update({n: f32_variant_launches[n] for n in
                                ('decode_composite', 'decode_banded')})
    for name in F32_RENDER:
        check(f32_render_launches[name] > 0,
              f'kernel {name} was not launched by the f32 renders')
    data = training_data(model_dev, code, bitfield, dev)
    train_launches, train_times = phase_train(model_dev, cfg, data, code,
                                               dev)
    del model_dev
    torch.cuda.empty_cache()
    f32_train_launches = phase_train_card_vs_cpu(model_cpu, cfg, data, code,
                                                 dev)
    for name in F32_TRAIN:
        check(f32_train_launches[name] > 0,
              f'kernel {name} was not launched by the f32 train step')

    # the bf16 UNet path: the same weights in the bf16 configuration
    model_bf16_cpu = make_model(SEED, CONFIG_BF16)
    model_bf16_dev = copy.deepcopy(model_bf16_cpu).to(dev)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    bf16_launches, bf16_gen = phase_bf16_slice(model_bf16_dev, model_dev, dev,
                                               times)
    bf16_vs_cpu = phase_bf16_card_vs_cpu(model_cpu, model_bf16_cpu, model_dev,
                                         model_bf16_dev)
    precision_ms = phase_unet_precision(model_dev.diffusion.denoising,
                                        model_bf16_dev.diffusion.denoising,
                                        dev)
    del model_dev
    torch.cuda.empty_cache()
    cfg_bf16 = Config.fromfile(str(CONFIG_BF16))
    bf16_train_launches, bf16_train = phase_train(
        model_bf16_dev, cfg_bf16, data, code, dev, timed=3, phase=7,
        required=TRAIN + ('attention_bf16', 'attention_bwd_bf16'))

    # launches: the generation kernels' counts from the phase-3 slice, the
    # render variants' from the phase-3 variant renders, the probe's from
    # its tool's path, the backward kernels' from phase 5, the f32 decode
    # kernels' from the f32 renders of phase 4 (forward, variants) and the
    # f32 train step of phase 6 (backward), the bf16 attention's from the
    # bf16 configuration's generation (forward) and train steps (backward)
    # of phase 7 (the paths that run them)
    launches = {n: serve_launches[n] if n in SERVING else
                variant_launches[n] if n in VARIANTS else
                probe_launches[n] if n in PROBE else
                f32_render_launches[n] if n in F32_RENDER else
                f32_train_launches[n] if n == 'decode_bwd' else
                bf16_launches[n] if n == 'attention_bf16' else
                bf16_train_launches[n] if n == 'attention_bwd_bf16' else
                train_launches[n]
                for n in WRAPPERS}
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms', 'device_ms', 'library_device_ms')
    report = [dict(name=name, route='cuda', source=KERNEL_META[name][0],
                   replaces=KERNEL_META[name][1], launches=launches[name],
                   **{k: kernels[name][k] for k in keys})
              for name in WRAPPERS]
    log(json.dumps({'kernels': report, 'slice_seconds': times,
                    'profiler_retakes': device_profile.retries,
                    'variants': variants, 'train': train_times,
                    'probe': probe, 'library_kernels': lib_kernels,
                    'bf16': dict(generation=bf16_gen, card_vs_cpu=bf16_vs_cpu,
                                 train=bf16_train,
                                 unet_forward_device_ms=precision_ms)}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
