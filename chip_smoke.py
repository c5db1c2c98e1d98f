#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ssdnerf_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ssdnerf_torch/csrc into build/kernels/, then
runs fourteen phases, any failure of which exits non-zero:

1. device: a CUDA card is present; TF32 is switched off for matmuls and
   convolutions, so every plain f32 reference is full f32;
2. each kernel vs its plain PyTorch version on the card, at the shapes of
   the flagship path (max error, median times by CUDA events, the least
   time the card could take for the same work, and the time of one
   PyTorch call computing the same function where there is one): march,
   the probe's per-row occupancy counts, decode and attention forward, the
   decode and attention backward at the training shapes (the attention
   also at the tiled config's levels, T = 768 at hd 40 and 192 and 48 at
   hd 80, with each kernel's shared memory), and the decode
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
   bf16 versions at the three flagship levels and the tiled config's
   three, bounded at the dense bf16 tensor rate (at T=1024, hd=64 and
   T=768, hd=40 the forward and backward are the wgmma kernels of
   csrc/attention_fwd_sm90.cu and csrc/attention_bwd_sm90.cu);
8. reconstruction: configs/paper_cfgs/ssdnerf_cars_recons1v.py unchanged
   (random seeded weights), 8 scenes with one 128x128 conditioning view
   each (view 0 of phase 5's synthetic images): ``eval_mode`` (its
   ``override_cfg``), ``val_step`` in 'guide_optim' (75 guided DDIM steps
   at 2^14 rays, then 25 ``val_optim`` steps of 4 inverse steps each),
   ``train_mode``, then a render of 4 other views per scene with its PSNR
   against them; wall seconds of the guide and the optimisation, the
   launch counts (the f32 attention backward and the bf16 decode backward
   among them), device time by range and kernel group of one profiled
   guided step and one ``val_optim`` step, peak memory of a few guided
   steps with ``guide_remat`` off and on, the guided DDIM under
   ``use_fp16`` (the bf16 attention forward and backward must launch);
   then 1 scene, 2 guided steps and 1 ``val_optim`` step on the card and
   on the CPU with the same weights and draws, in the shipped bf16 decode
   and in f32 (rays cut to 4096 a guide or inverse step for the CPU);
9. evaluation: a synthetic SRN-layout test set (8 scenes x 251 orbit
   views of 128x128 at SRN intrinsics, rendered from phase 3's scenes,
   PNGs by the port's writer), a checkpoint of the seed-0 model written by
   the port and read back bitwise through ``init_model(checkpoint=)``,
   the real-image Inception statistics of the set, then the port's CLI
   (``ssdnerf_torch.test.main``) on ssdnerf_cars_uncond.py (DDIM cut to
   EVAL_DDIM_STEPS, density rebuild, render of 251 views, FIDKID) and
   ssdnerf_cars_recons1v.py (view 64 conditions 'guide_optim', cut to
   EVAL_GUIDE_STEPS / EVAL_OPTIM_STEPS steps, render of the other 250
   views, PSNR / SSIM / substitute LPIPS; no FID, whose host work the
   uncond run does), at batch 8 with
   ``test_cfg.max_render_rays`` set from a measured render memory a ray;
   wall seconds by stage, peak memory of ``val_step`` and the render, the
   launch counts of both runs, one scene's mesh at 128^3 through
   ``save_mesh``; then the metrics, the Inception features and a cut-down
   ``evaluate_3d`` (1 scene, 4 views) on the card and on the CPU;
10. training through the CLI's entry (``ssdnerf_torch.train.main``, what
   ``python -m ssdnerf_torch.train`` runs, in this process with the TF32
   switches of a fresh one) at full width: a synthetic SRN-layout
   ``cars_train`` (16 scenes x 50 views of 128x128, phase 3's 8 scenes
   twice) and the flagship config cut only in run length, bank size and
   its eval hook's depth (each cut printed): a run of 12 iterations (bank
   16, checkpoints every 6, the updater's steps moved to 2 / 4 / 9, the
   eval hook at 12 on phase 9's test set, its DDIM cut and no FID / KID),
   a run of 6 and its resume to 12, whose batches and losses must agree
   with the first run's; files, the EMA, the updater's effects, the
   kernels' launch counts (the CLI prints them); then in-process a resume
   of the same checkpoint whose reloaded state must equal the files bit
   for bit, trained to 12 with the launch counts set to 0 just before;
   and 3 runner iterations of one scene on the card and on the CPU with
   the same weights and replayed draws, in bf16 and in f32;
11. stage-1 and two-stage training through the CLI's entry on phase 10's
   ``cars_train`` at the stage-1 configs' full widths (cuts printed: bank
   16, short runs, no evaluation): (a) stage1_cars_recons16v.py, 12
   iterations (the updater's step at 6), losses finite, ``train_psnr``
   rising, ``init_code`` moved, the bank's Adam counts, and in-process a
   resume from 6 whose losses must agree; (b) its 16-bit variant (as
   shipped it fails at the first init code in both packages, which is
   checked; run with ``init_from_mean`` off): the running statistics
   moved, the bank file's dtypes, and one allocation of the whole
   2458-row bank in 16 bits and in f32; (c) the filesystem variant: the
   writers' files reload bit for bit to the step's state, DirCopyHook's
   copies; (d) stage2_cars_uncond.py on (a)'s codes and checkpoint (the
   f32 attention forward and backward launched, stage 1's decoders
   untouched); (e) one stage-1 step of 1 scene on the card and on the
   CPU with TanhCode and NormalizedTanhCode, bf16 and f32, with the
   CPU's bitfields replayed as a control;
12. the tiled-triplane config (configs/new_cfgs/ssdnerf_cars_recons1v_
   tiled.py) unchanged, every width (codes laid out 6 x 128 x 384 by
   ``code_permute``; a six-level UNet of base 80 at 128 x 384 whose
   attention runs at (T, hd) = (768, 40), (192, 80) and (48, 80); bf16
   autocast sampling): (a) 4 timed train steps of 8 scenes with a 2458-row
   bank, device ms by group, peak memory, the attention calls by shape;
   (b) ``val_step`` over 8 scenes, one 128^2 view each (75 guided steps of
   the bf16 UNet, then 25 ``val_optim`` steps), the guide's and optim's
   walls, the attention calls by shape and dtype (the bf16 kernels at
   (768, 40)), one profiled step of each; (c) the train CLI's entry on
   phase 10's ``cars_train`` (cuts printed: bank 16, 6 iterations, no
   evaluation hook), then ``ssdnerf_torch.test.main`` on its checkpoint
   and phase 9's ``cars_test`` (phase 9's recons1v cuts, no image
   dumps); (d) one train step and 3 guided steps
   card vs CPU; (e) the flagship recons1v with ``image_cond`` (the UNet
   reads a conditioning view): one train step, 2 guided steps and a
   ``val_optim`` step card vs CPU;
13. the options no shipped config sets, on the flagship config at full
   width with ``cfg-options``-style overrides, each card vs CPU at phase
   6's limits (cuts printed): (a) ``train_step`` with
   ``density_partial_update``, ``log_grad_stats`` and a learnable scene
   base; (b) a render of 8 x 4 x 128^2 rays with ``compact_steps=None``
   and its gradients, against the ``compact_steps`` 64 render; (c) a
   decoder outside the kernel's shape (``base_layers`` (18, 64, 64), the
   SH concat), on torch ops; (d) ``bg_coords``; (e) two stage-1
   iterations on the host bank and on the device bank; (f)
   ``val_inverse_code`` with ``code_dropout`` and the raise of its
   ``train_step``; with each part's wall, device ms and launches;
14. the viewer, the demos and the tools at flagship width (cuts printed):
   (a) ``core/gui.py``'s ``SSDNeRFViewer`` on the seeded flagship model:
   the camera from ``demo/camera_spiral``, ``generate`` (batch 1, 50 DDIM
   steps) in f32 and under ``--fp16``, renders of the 512^2 view and the
   128^2 drag preview (median wall, profiled device ms), orbit frames, a
   scene file round trip and ``tools/convert_cache`` both ways (bitwise),
   a mesh, a 128^2 view card vs CPU (phase 4's limits), the march, the
   bf16 decode and both attention forwards launched; (b) the headless
   viewer CLI (``ssdnerf_torch.demo.ssdnerf_gui.main``) and the
   interpolation demo in process on a checkpoint of the seeded model; (c)
   ``validate_3d_learning`` and ``validate_diffusion_learning`` at a cut
   depth, their PSNRs and object fractions printed.

Each phase's wall seconds are printed as it ends.  The line before the
last is the card's name and power limit from nvidia-smi; the last line
is the result JSON.  Imports nothing of JAX.
"""
import contextlib
import copy
import io
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ssdnerf_torch import Config, init_model  # noqa: E402
from ssdnerf_torch import test as test_cli  # noqa: E402
from ssdnerf_torch.train import main as train_main  # noqa: E402
from ssdnerf_torch.apis import eval_utils  # noqa: E402
from ssdnerf_torch.apis.test import _save_scenes, evaluate_3d  # noqa: E402
from ssdnerf_torch.apis.train import build_runner  # noqa: E402
from ssdnerf_torch.convert import module_groups  # noqa: E402
from ssdnerf_torch.core.checkpoint import (  # noqa: E402
    model_state, read_checkpoint, save_checkpoint)
from ssdnerf_torch.core.evaluation import feature_nets  # noqa: E402
from ssdnerf_torch.core.evaluation.feature_nets import (  # noqa: E402
    make_inception_extractor, make_lpips)
from ssdnerf_torch.core.evaluation.fid import FID, FIDKID  # noqa: E402
from ssdnerf_torch.core.metrics import (  # noqa: E402
    eval_psnr, eval_ssim_skimage)
from ssdnerf_torch.core.gui import SSDNeRFViewer  # noqa: E402
from ssdnerf_torch.core.png import read_png, write_pngs  # noqa: E402
from ssdnerf_torch.data import (  # noqa: E402
    DataLoader, ShapeNetSRN, build_dataset)
from ssdnerf_torch.models.autodecoders import (  # noqa: E402
    DiffusionNeRF, MultiSceneNeRF)
from ssdnerf_torch.ops.kernels import _build  # noqa: E402
from ssdnerf_torch.ops.kernels import (  # noqa: E402
    WRAPPERS, launch_counts, reset_launches)
from ssdnerf_torch.ops.kernels import attention as k_attn  # noqa: E402
from ssdnerf_torch.ops.kernels import decode as k_dec  # noqa: E402
from ssdnerf_torch.ops.kernels import march as k_march  # noqa: E402
from ssdnerf_torch.ops import (  # noqa: E402
    get_cam_rays, near_far_from_aabb, sph_from_ray)
from ssdnerf_torch.ops import packing as ops_packing  # noqa: E402
from ssdnerf_torch.models.autodecoders import base as ad_base  # noqa: E402
from ssdnerf_torch.models.autodecoders import (  # noqa: E402
    diffusion_nerf as ad_dn)
from ssdnerf_torch.models.autodecoders import (  # noqa: E402
    multiscene as ad_ms)
from ssdnerf_torch.models.autodecoders.multiscene import (  # noqa: E402
    DeviceSceneCache)
from ssdnerf_torch.models.autodecoders.base import adam_init  # noqa: E402
from ssdnerf_torch.models.decoders import renderer as dec_renderer  # noqa
from ssdnerf_torch.models.decoders.renderer import (  # noqa: E402
    GROUP_RAYS, density_jitter, volume_render)
from ssdnerf_torch.models.decoders.triplane import (  # noqa: E402
    TriPlaneDecoder)
from ssdnerf_torch.runner.hooks import Hook, build_hooks  # noqa: E402
from ssdnerf_torch.runner.loop import Runner  # noqa: E402
from ssdnerf_torch.runner.optim import build_optimizers  # noqa: E402
from ssdnerf_torch.demo import ssdnerf_gui  # noqa: E402
from ssdnerf_torch.demo import (  # noqa: E402
    interp_diffusion_nerf_ddim as interp_demo)
from ssdnerf_torch.tools import (  # noqa: E402
    convert_cache, march_scalar_probe, validate_3d_learning,
    validate_diffusion_learning)
from ssdnerf_torch.tools.inception_stat import inception_stats  # noqa
from ssdnerf_torch.tools.decode_profile import (  # noqa: E402
    BALL_VIEWS, ball_bitfield, ball_layouts, look_at_pose, look_at_views)
from ssdnerf_torch.tools.march_scalar_probe import median_ms  # noqa: E402

CONFIG = ROOT / 'configs' / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'
CONFIG_BF16 = ROOT / 'configs' / 'new_cfgs' / 'ssdnerf_cars_uncond_bf16.py'
CONFIG_RECONS = ROOT / 'configs' / 'paper_cfgs' / 'ssdnerf_cars_recons1v.py'
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
# the kernels of a reconstruction (f32 UNet, bf16 decode as shipped), and
# those only the use_fp16 guide runs
RECONS = ('march', 'decode_bf16', 'decode_bwd_bf16', 'attention',
          'attention_bwd')
RECONS_FP16 = ('attention_bf16', 'attention_bwd_bf16')
# the attention levels (T, hd) at batch 8 x 4 heads: the flagship's 32^2,
# 16^2 and 8^2; the tiled config's 16x48, 8x24 and 4x12 (and the middle
# block), each with its calls a UNet pass
FLAGSHIP_ATTN = ((1024, 64), (256, 128), (64, 128))
TILED_ATTN = ((768, 40), (192, 80), (48, 80))
TILED_PASS = {(768, 40): 5, (192, 80): 5, (48, 80): 6}
# phase 5's synthetic views: view 0 conditions a reconstruction, these are
# rendered from the result
RECONS_VIEWS = (10, 20, 30, 40)
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
                ('attention_bwd_bf16', 'attention_bwd.*(sm90|bf16|bfloat16)'),
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
    # the paths' shapes (T=1024, hd=64; the tiled T=768, hd=40) take the
    # wgmma forward; others attention.cu's mma.sync one
    'attention_bf16': ('ssdnerf_torch/csrc/attention_fwd_sm90.cu',
                       'ssdnerf_tpu/ops/pallas/attention.py:44'),
    # likewise the wgmma backward
    'attention_bwd_bf16': ('ssdnerf_torch/csrc/attention_bwd_sm90.cu',
                           'ssdnerf_tpu/ops/pallas/attention.py:58'),
}


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


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


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


# ---------------------------------------------------------------- phases
# torch's TF32 switches as a fresh process has them (phase 1 turns both
# off for this one)
FRESH_TF32 = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def fresh_process_tf32():
    """While open, the TF32 switches a user's fresh process has."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = FRESH_TF32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_device():
    check(torch.cuda.is_available(), 'no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'phase 1 device: {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}; allow_tf32 matmul='
        f'{torch.backends.cuda.matmul.allow_tf32} cudnn='
        f'{torch.backends.cudnn.allow_tf32}')
    return torch.device('cuda')


def device_profile(fn, calls=30, tries=3, expect=None, require=()):
    """Device ms a call of ``fn`` spends in each kernel (or copy) it
    launches, by name: ``torch.profiler`` over ``calls`` calls after a
    warm-up call.  Unlike a CUDA-event time of one call, this leaves out
    the host's launch latency, which a kernel of tens of microseconds does
    not hide.  A trace in which a kernel reads 0 device ms, that holds no
    kernel, that holds none of the group ``expect`` (of PORT_KERNELS) or
    not every name of ``require`` (substrings of kernel names), or in
    which a kernel of ``require`` has a count of events that is not a
    multiple of ``calls`` (every call launches it the same number of
    times, so the trace lost events and would undercount the sum) is taken
    again, up to ``tries`` times; then the phase fails.
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
        ms, count = {}, {}
        for e in events:
            if e.device_type == DeviceType.CUDA and e.name not in annotations:
                ms[e.name] = ms.get(e.name, 0.0) + (
                    e.time_range.elapsed_us() / (1e3 * calls))
                count[e.name] = count.get(e.name, 0) + 1
        zero = sorted(n for n, t in ms.items() if t <= 0)
        lost = sorted(n for n, c in count.items() if c % calls
                      and any(r in n for r in require))
        found = (expect is None or any(kernel_group(n, None) == expect
                                       for n in ms)) and all(
            any(r in n for n in ms) for r in require)
        if ms and not zero and not lost and found:
            return ms
        device_profile.retries += 1
    raise AssertionError(f'device_profile: {tries} traces of {calls} calls; '
                         f'the last read 0 ms for {zero}, counted events '
                         f'not a multiple of the calls for {lost}, '
                         f'{"found" if found else "lacked"} {expect} '
                         f'{list(require)}, {len(ms)} kernels')


device_profile.retries = 0


def phase_kernels(dev):
    """Each kernel vs its plain version at flagship shapes; the names of
    the kernels of the attention's library yardstick."""
    g = torch.Generator().manual_seed(SEED + 11)
    results = {}

    def compare(name, tag, kernel, plain, tol, flops, moved,
                relative=False, library=None, tensor_flops=0,
                tensor_rate=PEAK_TF32_FLOPS, passes=3, f32_plain=None,
                kernels=(), smem=None):
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
        that skipped the bf16 roundings would not meet.  Each name in
        ``kernels`` must be among the kernels of the row's device trace,
        whose names are printed.  ``smem``: the dynamic shared memory of
        the row's kernels (bytes by kernel), printed and kept.  The first
        row of a kernel is its entry of the result; every row is kept
        under its ``rows``."""
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
        traced = device_profile(kernel, expect=name, require=kernels)
        dev_ms = sum(traced.values())
        if kernels:
            names = [re.sub(r'^(void )?(\(anonymous namespace\)::)?', '',
                            n).split('(')[0] for n in traced]
            log(f'phase 2 {tag}: device trace ' + ', '.join(
                f'{n} {t:.4f} ms' for n, t in zip(names, traced.values())))
        for k_name in kernels:
            check(any(k_name in n for n in traced),
                  f'{tag}: {k_name} not in the device trace {sorted(traced)}')
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
            + f', {moved / 1e6:.1f} MB)'
            + ('' if smem is None else f' shared memory {smem} B'))
        for e, t in zip(shown, tols):
            check(e <= t, f'{tag}: error {e} > {t}')
        row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   bound_all_f32_ms=f32_ms, device_ms=dev_ms,
                   library_device_ms=lib_dev_ms, shape=tag, smem_bytes=smem)
        results.setdefault(name, dict(row, rows=[]))['rows'].append(row)

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

    # attention: G = batch 8 x 4 heads at the flagship's 32^2, 16^2 and 8^2
    # levels and the tiled config's 16x48, 8x24 and 4x12 (TILED_ATTN).
    # Bound: the products (4 hd T^2 forward, 10 hd T^2 backward a program)
    # in three TF32 passes on the tensor cores, the softmax's elementwise
    # work (4 T^2 forward, 8 T^2 backward) in f32, or the bytes
    for T_, hd in FLAGSHIP_ATTN + TILED_ATTN:
        q, k, v = (torch.randn((32, T_, hd), generator=g).to(dev)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(hd)
        # library: one f32 scaled_dot_product_attention call (TF32 off)
        compare('attention', f'attention G=32 T={T_} hd={hd}',
                lambda: k_attn.attention(q, k, v, scale),
                lambda: k_attn.attention_plain(q, k, v, scale), 2e-5,
                32 * T_ * T_ * 4, 4 * nbytes(q),
                library=lambda: sdpa(q, k, v, scale),
                tensor_flops=3 * 32 * T_ * T_ * 4 * hd,
                smem=k_attn.smem_bytes(T_, hd, torch.float32))
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
                tensor_flops=3 * 32 * T_ * T_ * 10 * hd,
                smem=k_attn.smem_bytes(T_, hd, torch.float32))
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
    # plain version at the Pallas kernels' rounding points, a mean within
    # 1e-5 of it, and within half the gap to f32 (compare's f32_plain).
    # Where the library's gate admits the shape (k_attn.sm90_supported: hd
    # 40 or 64 at T a multiple of 128) the wgmma kernels run (their names
    # must be in the row's trace), elsewhere attention.cu's mma.sync ones
    for T_, hd in FLAGSHIP_ATTN + TILED_ATTN:
        q, k, v, do = (torch.randn((32, T_, hd), generator=g).to(dev)
                       .bfloat16() for _ in range(4))
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        scale = 1.0 / math.sqrt(hd)
        sm90 = k_attn.sm90_supported(T_, hd)
        sm90_bwd = k_attn.sm90_supported(T_, hd, backward=True)
        compare('attention_bf16', f'attention bf16 G=32 T={T_} hd={hd}',
                lambda: k_attn.attention(q, k, v, scale),
                lambda: k_attn.attention_plain(q, k, v, scale), 2.0 ** -7,
                32 * T_ * T_ * 4, 4 * nbytes(q), relative=True,
                library=lambda: sdpa(q, k, v, scale),
                tensor_flops=32 * T_ * T_ * 4 * hd,
                tensor_rate=PEAK_BF16_FLOPS, passes=1,
                f32_plain=lambda: k_attn.attention_plain(q32, k32, v32,
                                                         scale),
                kernels=(('attention_fwd_sm90_kernel',) if sm90 else
                         ('attention_fwd_bf16_kernel',)),
                smem=None if sm90 else k_attn.smem_bytes(T_, hd,
                                                         torch.bfloat16))
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
                tensor_rate=PEAK_BF16_FLOPS, passes=1,
                f32_plain=lambda: k_attn.attention_backward_plain(
                    q32, k32, v32, do32, scale),
                kernels=(('attention_bwd_dkdv_sm90_kernel',
                          'attention_bwd_dq_sm90_kernel') if sm90_bwd else
                         ('attention_bwd_dkdv_bf16_kernel',
                          'attention_bwd_dq_bf16_kernel')),
                smem=None if sm90_bwd else k_attn.smem_bytes(T_, hd,
                                                             torch.bfloat16))
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
    # groups a scene).  Work and slot bytes are counted on valid slots;
    # the fused and banded kernels run the base products on the tensor
    # cores as the split forward does (csrc/decode_fwd.cuh).
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
            (1e-5, 5e-5, 1e-5), n_valid * (decode_flops(C, hidden)
                                           - decode_products(C, hidden)
                                           + 40),
            nbytes(planes, params, dir_l, lay['soffs'], lay['pvalid'])
            + n_valid * 24 + S * n_rays * 20,
            tensor_flops=3 * n_valid * decode_products(C, hidden))
    band = (planes, lay['xyz_b'], params, hidden, lay['rid_b'], dir_l,
            lay['win'])
    compare('decode_banded', f'decode banded S={S} slots={M_l} '
            f'(valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_banded(*band),
            lambda: k_dec.triplane_decode_banded_plain(*band), 1e-5,
            n_valid * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes, params, dir_l, lay['win']) + n_valid * 32,
            tensor_flops=3 * n_valid * decode_products(C, hidden))
    # the variants in bf16: per-ray sums (composite) and raw outputs
    # (banded), held as the bf16 decode forward
    comp_b = (planes_b, comp[1], params_b) + comp[3:]
    compare('decode_composite_bf16', f'decode+composite bf16 S={S} '
            f'slots={M_l} (valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_composite(*comp_b),
            lambda: k_dec.triplane_decode_composite_plain(*comp_b),
            2.0 ** -8, n_valid * (decode_flops(C, hidden)
                                  - decode_products(C, hidden) + 40),
            nbytes(planes_b, params, dir_l, lay['soffs'], lay['pvalid'])
            + n_valid * 24 + S * n_rays * 20, relative=True,
            tensor_flops=n_valid * decode_products(C, hidden), passes=1,
            f32_plain=lambda: k_dec.triplane_decode_composite_plain(
                planes_f, *comp_b[1:]))
    band_b = (planes_b, band[1], params_b) + band[3:]
    compare('decode_banded_bf16', f'decode banded bf16 S={S} slots={M_l} '
            f'(valid {n_valid}, P=512)',
            lambda: k_dec.triplane_decode_banded(*band_b),
            lambda: k_dec.triplane_decode_banded_plain(*band_b), 2.0 ** -8,
            n_valid * (decode_flops(C, hidden) - decode_products(C, hidden)),
            nbytes(planes_b, params, dir_l, lay['win']) + n_valid * 32,
            relative=True, tensor_flops=n_valid * decode_products(C, hidden),
            passes=1,
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
    if not isinstance(config, Config):
        config = Config.fromfile(str(config))
    model = init_model(config, 'cpu', seed)
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
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
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
    Returns (profiled wall ms, device ms, parts, groups, kernels by
    device time: (name, (launches, ms)))."""
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
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return wall_ms, sum(parts.values()), parts, groups, ranked


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
    code_ = model.code_activation.inverse(code, model.code_act)
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
    for name, (n, ms) in top[:8]:
        log(f'phase {phase} kernel {ms:8.2f} ms x{n:4d} {name[:90]}')
    # the attention kernels, each with the group it is billed to
    for name, (n, ms) in top:
        group = kernel_group(name, None)
        if group.startswith('attention'):
            log(f'phase {phase} attention kernel {ms:8.4f} ms x{n:4d} '
                f'[{group}] {name[:90]}')
    norm = model.diffusion.norm_factor.item()
    occ = np.unpackbits(bank.density_bitfield[:S].cpu().numpy()).mean()
    moved = (bank.code_[:S] - code0).abs().max().item()
    counters = bank.step[:S].tolist()
    log(f'phase {phase} train: {S} scenes, extra_scene_step {ess}, bank '
        f'{bank.cache_size} scenes; peak memory {peak:.2f} GiB; '
        f'norm_factor {norm:.6f}; occupancy {occ:.4f}; codes moved '
        f'{moved:.3e}; Adam steps {counters}; launches {launches}')
    # the factor moves only with scale_norm (the 16-bit and tiled configs
    # train without it)
    check(math.isfinite(norm) and (
        norm != 1.0 or not model.diffusion.ddpm_loss.scale_norm),
        'norm_factor')
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


def phase_train_card_vs_cpu(model_cpu, cfg, data, code, dev, phase=6,
                            dtypes=('bfloat16', 'float32')):
    """One train step of scene 0 with 1 inner step and 1024 rays, on the
    card and on the CPU, from the same weights, codes and draws, in bf16
    (the decode as shipped) and with ``compute_dtype`` 'float32'.  f32:
    losses rel 1e-4, gradients (max |card - cpu| / max |cpu| over each
    whole module) 1e-3; bf16: each limit, or half the CPU's bf16-vs-f32
    gap of the same quantity where that is larger (the UNet's gradient
    and the diffusion loss do not depend on the decode, so their gap is
    ~0 and the f32 limit holds).  Returns the launches of the f32 step on
    the card (counts set to 0 just before it).  ``dtypes``: the decode's,
    the f32 one last; ``phase`` labels the lines."""
    tc = dict(model_cpu.train_cfg, extra_scene_step=1, n_inverse_rays=1024,
              n_decoder_rays=1024)
    data = {k: v[:1].cpu() for k, v in data.items()}
    code_ = model_cpu.code_activation.inverse(code[:1].cpu(),
                                              model_cpu.code_act)
    H = model_cpu.grid_size
    batch = dict(code_=code_,
                 density_grid=torch.zeros((1, H ** 3), dtype=torch.float16),
                 density_bitfield=torch.zeros((1, H ** 3 // 8),
                                              dtype=torch.uint8))
    model_cpu.train_cfg = tc
    num_pixels = math.prod(data['cond_imgs'].shape[1:4])
    draws = model_cpu.train_draws(
        1, num_pixels, torch.Generator().manual_seed(SEED + 6),
        num_views=data['cond_imgs'].shape[1])
    # a mid timestep: the SNR weight of the last ones is 0, which would
    # leave nothing to compare
    draws['t'] = torch.tensor([model_cpu.diffusion.num_timesteps // 2])
    outs = {}
    for dtype in dtypes:
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
            log(f'phase {phase} {tag} ({dtype}): '
                f'{time.perf_counter() - t0:.2f} s')
            del model

    def rel(a, b, k):
        if k in a.get('logs', {}):
            return abs(a['logs'][k] - b['logs'][k]) / abs(b['logs'][k])
        return ((a[k] - b[k]).abs().max() / b[k].abs().max()).item()

    for dtype in dtypes:
        card, cpu = outs[dtype, 'card'], outs[dtype, 'cpu']
        flips = (np.unpackbits(card['bits'].numpy())
                 != np.unpackbits(cpu['bits'].numpy())).mean()
        log(f'phase {phase} card vs cpu ({dtype}): bitfield flipped share '
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
            log(f'phase {phase} {k} ({dtype}): rel_err {err:.2e} '
                f'(tol {tol:.2e}'
                + (f'; bf16-vs-f32 gap on the cpu {gap:.2e}'
                   if dtype == 'bfloat16' else '') + ')')
            check(err <= tol, f'phase {phase} card vs cpu ({dtype}): {k}')
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


def recons_inputs(data, S=8):
    """The conditioning data of a reconstruction (view 0 of ``data``, one
    128x128 view a scene) and its test views (RECONS_VIEWS)."""
    cond = {k: v[:S, :1].contiguous() for k, v in data.items()}
    test = {k: v[:S, list(RECONS_VIEWS)].contiguous()
            for k, v in data.items()}
    return cond, test


@contextlib.contextmanager
def timed_ranges(model, walls):
    """Adds to ``walls`` the wall seconds (to a device synchronise) of each
    ``val_guide`` and ``val_optim`` call ``val_step`` makes, under their
    ranges' names."""
    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    model.val_guide = timed('val_step.guide', model.val_guide)
    model.val_optim = timed('val_step.optim', model.val_optim)
    try:
        yield
    finally:
        del model.val_guide, model.val_optim


def psnr_db(img, target):
    mse = ((img.float() - target.float()) ** 2).mean().item()
    return -10 * math.log10(max(mse, 1e-10))


def phase_recons(model, data, dev):
    """Single-view reconstruction at the flagship width (recons1v's
    test_cfg unchanged): ``eval_mode``, ``val_step`` ('guide_optim') on 8
    scenes, ``train_mode``, a render of the 4 test views; then one guided
    step and one ``val_optim`` step under the profiler, a few guided steps
    with ``guide_remat`` off and on (peak memory), and the guided DDIM
    under ``use_fp16``.  Each of RECONS must launch in the reconstruction,
    each of RECONS_FP16 under ``use_fp16``."""
    tcfg = model.test_cfg
    cond, test = recons_inputs(data)
    S = cond['cond_imgs'].shape[0]
    num_pixels = math.prod(cond['cond_imgs'].shape[1:4])
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    model.eval_mode()
    check(model.diffusion_ema.ddpm_loss.weight_scale == 1.0
          and model.diffusion.ddpm_loss.weight_scale == 1.0,
          'eval_mode: override_cfg not applied')
    walls = {}
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_ranges(model, walls):
        code, grid, bitfield = model.val_step(cond, generator=gen)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.train_mode()
    check(model.diffusion_ema.ddpm_loss.weight_scale == 4.0,
          'train_mode: weight_scale not restored')
    h, w = test['cond_imgs'].shape[2:4]
    img, depth = model.render(code, bitfield, h, w,
                              test['cond_intrinsics'], test['cond_poses'])
    psnrs = [psnr_db(img[i], test['cond_imgs'][i]) for i in range(S)]
    occ = np.unpackbits(bitfield.cpu().numpy()).mean()
    log(f'phase 8 reconstruction ({tcfg["cond_mode"]}, {S} scenes, 1 view '
        f'of 128x128): val_step {total_s:.3f} s = guide '
        f'{walls["val_step.guide"]:.3f} s ({tcfg["num_timesteps"]} guided '
        f'DDIM steps at {tcfg["n_inverse_rays"]} rays) + optim '
        f'{walls["val_step.optim"]:.3f} s ({tcfg["n_inverse_steps"]} steps x '
        f'{tcfg["extra_scene_step"] + 1} inverse steps); peak memory '
        f'{peak:.2f} GiB; launches {launches}')
    log(f'phase 8 outputs: code {tuple(code.shape)} |code|max='
        f'{code.abs().max().item():.3f}; grid {grid.dtype} max '
        f'{grid.float().max().item():.4g}; occupancy {occ:.4f}; render of '
        f'{len(RECONS_VIEWS)} other views PSNR (dB) mean '
        f'{statistics.mean(psnrs):.3f}, per scene '
        + ' '.join(f'{p:.2f}' for p in psnrs) + ' (random weights: no bar)')
    check(code.shape == (S,) + model.code_size, 'recons code shape')
    check(torch.isfinite(code).all().item(), 'recons codes not finite')
    check(not torch.isnan(grid).any().item(), 'recons grid NaN')
    check(grid.dtype == torch.float16, 'recons grid dtype')
    for name, t in (('image', img), ('depth', depth)):
        check(torch.isfinite(t).all().item(), f'recons {name} not finite')
    for name in RECONS:
        check(launches[name] > 0, f'kernel {name} was not launched by the '
              'reconstruction')

    # one guided step and one val_optim step under the profiler
    model.test_cfg = dict(tcfg, num_timesteps=1, n_inverse_steps=1)
    try:
        draws = model.val_draws(S, num_pixels, gen, dev)
        profiles = {
            'guide': profile_step(lambda: model.val_guide(
                cond, draws['noise'], draws), ranges=('val_step.guide',)),
            'optim': profile_step(lambda: model.val_optim(
                cond, draws, code_=model.code_activation.inverse(code),
                density_grid=grid, density_bitfield=bitfield),
                ranges=('val_step.optim',))}
    finally:
        model.test_cfg = tcfg
    for part, (wall_ms, dev_ms, _, groups, top) in profiles.items():
        log(f'phase 8 profiled {part} step: wall {wall_ms:.1f} ms, device '
            f'{dev_ms:.1f} ms; by group: ' + ', '.join(
                f'{k} {v:.2f} ms ({v / dev_ms:.1%})'
                for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
        for name, (n, ms) in top[:6]:
            log(f'phase 8 {part} kernel {ms:8.3f} ms x{n:4d} {name[:90]}')
        for name in ('attention_bwd', 'decode_bwd_bf16'):
            check(groups.get(name, 0.0) > 0, f'kernel {name} read no device '
                  f'time in the profiled {part} step')

    # guide_remat off and on: peak memory of a few guided steps
    few = dict(tcfg, num_timesteps=3, cond_mode='guide')
    remat = {}
    for on in (False, True):
        model.test_cfg = dict(few, guide_remat=on)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 2 ** 30
            t0 = time.perf_counter()
            model.val_guide(cond, draws['noise'], generator=gen)
            torch.cuda.synchronize()
            remat[on] = dict(peak_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30, base_gib=base,
                             wall_s=time.perf_counter() - t0)
        finally:
            model.test_cfg = tcfg
    log('phase 8 guide_remat off / on, 3 guided steps: peak memory '
        f'{remat[False]["peak_gib"]:.2f} / {remat[True]["peak_gib"]:.2f} '
        f'GiB (allocated before them {remat[False]["base_gib"]:.2f} GiB), '
        f'wall {remat[False]["wall_s"]:.3f} / {remat[True]["wall_s"]:.3f} s')

    # the guided DDIM under use_fp16: bf16 chain and UNet
    model.test_cfg = dict(tcfg, cond_mode='guide')
    model.autocast_dtype = 'bfloat16'
    reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code16, _, _ = model.val_guide(cond, draws['noise'], generator=gen)
        torch.cuda.synchronize()
        fp16_s = time.perf_counter() - t0
    finally:
        model.test_cfg, model.autocast_dtype = tcfg, None
    fp16_launches = launch_counts()
    log(f'phase 8 guided DDIM {tcfg["num_timesteps"]} steps x {S} scenes, '
        f'wall s f32 / use_fp16: {walls["val_step.guide"]:.3f} / '
        f'{fp16_s:.3f}; use_fp16 launches {fp16_launches}')
    check(torch.isfinite(code16).all().item(), 'use_fp16 recons codes')
    for name in RECONS_FP16:
        check(fp16_launches[name] > 0, f'kernel {name} was not launched by '
              'the use_fp16 guide')
    return launches, fp16_launches, dict(
        val_step_s=total_s, range_wall_s=walls, peak_gib=peak,
        psnr_db=psnrs, occupancy=occ, use_fp16_guide_s=fp16_s,
        profiled={k: dict(wall_ms=v[0], device_ms=v[1],
                          device_ms_by_group=v[3])
                  for k, v in profiles.items()},
        remat={str(k): v for k, v in remat.items()})


def phase_recons_card_vs_cpu(model_cpu, model_dev, data, dev, phase=8,
                             dtypes=('bfloat16', 'float32')):
    """1 scene: 2 guided DDIM steps, then 1 ``val_optim`` step (4 inverse
    steps) from the guide's codes and f16 grid, then a render of one test
    view, on the card and on the CPU with the same weights and draws, in
    the shipped bf16 decode and in f32.  The rays of a guide or inverse
    step are cut from 2^14 to 4096 (ray batches of the view) for the CPU;
    the prior's timestep is a mid one (phase 6: the SNR weight of the last
    is 0).  Tolerances (PERF.md): f32: guide codes max abs 1e-3, the guide's
    f32 grid max rel 5e-3 (phase 4), the final codes at most 1e-3 of the
    entries off by more than 1e-3 and none by more than 2 x lr x 4 steps
    (an Adam step is about +-lr whatever the gradient's size, so an entry
    whose gradient is within the card's error of 0 steps the other way),
    the image max 2e-2 / mean 1e-3 (phase 4); bf16: each limit or half the
    CPU's bf16-vs-f32 gap of the same measure, where that is larger (phase
    6); bits flipped at most 1e-3 in both.  ``dtypes``: the decode's, the
    f32 one last; ``phase`` labels the lines."""
    cond, test = recons_inputs({k: v.cpu() for k, v in data.items()}, S=1)
    tcfg = dict(model_cpu.test_cfg, num_timesteps=2, n_inverse_steps=1,
                n_inverse_rays=4096)
    lr = tcfg['optimizer']['lr']
    saved = model_cpu.test_cfg
    model_cpu.test_cfg = tcfg
    try:
        draws = model_cpu.val_draws(
            1, math.prod(cond['cond_imgs'].shape[1:4]),
            torch.Generator().manual_seed(SEED + 10),
            num_views=cond['cond_imgs'].shape[1])
    finally:
        model_cpu.test_cfg = saved
    draws['optim'][0]['t'] = torch.tensor(
        [model_cpu.diffusion.num_timesteps // 2])
    view = {k: v[:, :1] for k, v in test.items()}
    outs = {}
    for dtype in dtypes:
        for tag, model, d in (('card', model_dev, dev), ('cpu', model_cpu,
                                                         'cpu')):
            t0 = time.perf_counter()
            saved = model.test_cfg
            model.test_cfg = tcfg
            model.eval_mode()
            try:
                with decode_dtype(model, dtype):
                    c = to_device(cond, d)
                    dr = to_device(draws, d)
                    g_code, g_grid, g_bits = model.val_guide(
                        c, dr['noise'], dr)
                    code, _, bits = model.val_optim(
                        c, dr, code_=model.code_activation.inverse(g_code),
                        density_grid=g_grid.half(), density_bitfield=g_bits)
                    img, _ = model.render(code, bits, *view[
                        'cond_imgs'].shape[2:4], view['cond_intrinsics'].to(d),
                        view['cond_poses'].to(d))
            finally:
                model.train_mode()
                model.test_cfg = saved
            outs[dtype, tag] = {k: v.cpu() for k, v in dict(
                g_code=g_code, g_grid=g_grid, g_bits=g_bits, code=code,
                bits=bits, img=img).items()}
            log(f'phase {phase} card vs cpu {tag} ({dtype}): '
                f'{time.perf_counter() - t0:.2f} s')

    def flipped(a, b):
        return float((np.unpackbits(a.numpy())
                      != np.unpackbits(b.numpy())).mean())

    measures = {
        'guide code max abs': (lambda a, b: (a['g_code'] - b['g_code']).abs(
            ).max().item(), 1e-3),
        'guide grid max rel': (lambda a, b: ((a['g_grid'] - b['g_grid']).abs()
                                             / (b['g_grid'].abs() + 1e-3)
                                             ).max().item(), 5e-3),
        'guide bits flipped': (lambda a, b: flipped(a['g_bits'], b['g_bits']),
                               1e-3),
        'code share off > 1e-3': (lambda a, b: ((a['code'] - b['code']).abs()
                                                > 1e-3).float().mean().item(),
                                  1e-3),
        'code max abs': (lambda a, b: (a['code'] - b['code']).abs().max(
            ).item(), 2 * lr * (tcfg['extra_scene_step'] + 1)),
        'bits flipped': (lambda a, b: flipped(a['bits'], b['bits']), 1e-3),
        'image max abs': (lambda a, b: (a['img'] - b['img']).abs().max(
            ).item(), 2e-2),
        'image mean abs': (lambda a, b: (a['img'] - b['img']).abs().mean(
            ).item(), 1e-3)}
    result = {}
    ok = True
    for dtype in dtypes:
        card, cpu = outs[dtype, 'card'], outs[dtype, 'cpu']
        for name, (fn, f32_tol) in measures.items():
            err, tol, gap = fn(card, cpu), f32_tol, None
            if dtype == 'bfloat16' and 'flipped' not in name:
                gap = fn(cpu, outs['float32', 'cpu'])
                tol = max(f32_tol, 0.5 * gap)
            log(f'phase {phase} card vs cpu ({dtype}) {name}: {err:.3e} (tol '
                f'{tol:.3e}' + (f'; bf16-vs-f32 gap on the cpu {gap:.3e}'
                                if gap is not None else '') + ')')
            result[f'{dtype} {name}'] = dict(err=err, tol=tol, gap=gap)
            ok = ok and err <= tol
    check(ok, f'phase {phase} card vs cpu')
    return result


# ------------------------------------------------------------ phase 9
# the kernels of the two evaluations: generation (f32 UNet, bf16 decode)
# and reconstruction (the guide's and val_optim's backwards too)
EVAL_UNCOND = ('march', 'decode_bf16', 'attention')
EVAL_RECONS = RECONS
EVAL_VIEWS = 251            # SRN cars_test: 251 views a scene
# the guided DDIM steps and val_optim steps of a reconstruction evaluated
# through the test CLI (phase 9, phase 12 (c)): a cut of the configs' 75
# and 25, which phases 8 and 12 (b) run in full
EVAL_GUIDE_STEPS, EVAL_OPTIM_STEPS = 15, 5
# the DDIM steps of a generation evaluated through the test CLI (phase 9)
# or the eval hook (phase 10): a cut of the config's 50, which phase 3
# runs in full
EVAL_DDIM_STEPS = 10
EVAL_SIZE = 128             # of 128 x 128
MESH_RES = 128              # the mesh's grid, 128^3 (256 by default)
# the render's share of the card a chunk of max_render_rays may take
RENDER_BUDGET_GIB = 16.0


def write_srn_set(model, code, bitfield, root, num_views, chunk):
    """An SRN-layout test set (``tools/make_synthetic_srn.py``'s layout,
    poses in the raw SRN frame, the dataset's radius 0.5 undone) of the
    port's renders of ``code`` from ``num_views`` orbit views of 128x128
    at SRN intrinsics, PNGs by the port's writer.  Returns the wall
    seconds of rendering and of writing."""
    S = code.shape[0]
    poses, intr = orbit_cameras(S, num_views, code.device)
    t0 = time.perf_counter()
    imgs = torch.cat([model.render(code, bitfield, EVAL_SIZE, EVAL_SIZE,
                                   intr[:, i:i + chunk],
                                   poses[:, i:i + chunk])[0]
                      for i in range(0, num_views, chunk)], 1)
    imgs = (imgs.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
    t1 = time.perf_counter()
    raw = poses.cpu().numpy().astype(np.float64)
    raw[..., :3, 3] *= 0.5
    f, _, cx, cy = SRN_INTRINSICS
    for s in range(S):
        scene = root / f'car_{s:04d}'
        (scene / 'rgb').mkdir(parents=True)
        (scene / 'pose').mkdir()
        (scene / 'intrinsics.txt').write_text(
            f'{f} {cx} {cy} 0.\n0. 0. 0.\n1.\n{EVAL_SIZE} {EVAL_SIZE}\n')
        for v in range(num_views):
            (scene / 'pose' / f'{v:06d}.txt').write_text(
                ' '.join(f'{x:.17g}' for x in raw[s, v].reshape(-1)) + '\n')
        write_pngs([str(scene / 'rgb' / f'{v:06d}.png')
                    for v in range(num_views)], imgs[s])
    return t1 - t0, time.perf_counter() - t1


def render_bytes_per_ray(model, code, bitfield, views=4):
    """Peak device bytes a ray of a render of ``views`` orbit views a scene
    takes (the render's peak over what was allocated before it)."""
    S = code.shape[0]
    poses, intr = orbit_cameras(S, views, code.device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.render(code, bitfield, EVAL_SIZE, EVAL_SIZE, intr, poses)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / (S * views * EVAL_SIZE ** 2)


@contextlib.contextmanager
def stage_walls(walls, targets):
    """For the block, each ``(owner, attribute, stage)`` of ``targets``
    replaced by a wrapper that adds its wall seconds (to a device
    synchronise) to ``walls[stage]`` and counts its calls; the stages
    'render' and 'val_step' also keep their largest peak of device memory
    over what was allocated when they started (``walls[stage +
    '_peak_gib']``)."""
    saved = []

    def wrap(fn, stage):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            peak = stage in ('render', 'val_step')
            if peak:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[stage] = walls.get(stage, 0.0) + time.perf_counter() - t0
            walls[stage + '_calls'] = walls.get(stage + '_calls', 0) + 1
            if peak:
                walls[stage + '_peak_gib'] = max(
                    walls.get(stage + '_peak_gib', 0.0),
                    (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
            if stage == 'dataset read':
                walls['pngs'] = walls.get('pngs', 0) + sum(
                    len(out.get(k, ())) for k in ('cond_imgs', 'test_imgs'))
            return out
        return run

    for owner, attr, stage in targets:
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, wrap(getattr(owner, attr), stage))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def timed_lpips(walls):
    """``feature_nets.make_lpips`` whose LPIPS calls add to
    ``walls['lpips']``."""
    make = feature_nets.make_lpips

    def make_timed(*args, **kwargs):
        inner = make(*args, **kwargs)

        def run(a, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(a, b)
            torch.cuda.synchronize()
            walls['lpips'] = walls.get('lpips', 0.0) + time.perf_counter() - t0
            return out

        run.substitute_weights = inner.substitute_weights
        run.model = inner.model
        return run

    return make_timed


def eval_stages(walls):
    return stage_walls(walls, [
        (ShapeNetSRN, '__getitem__', 'dataset read'),
        (DiffusionNeRF, 'val_step', 'val_step'),
        (MultiSceneNeRF, 'render', 'render'),
        (eval_utils, 'eval_psnr', 'psnr_ssim'),
        (eval_utils, 'eval_ssim_skimage', 'psnr_ssim'),
        (eval_utils, 'write_pngs', 'viz dumps'),
        (eval_utils, 'visualize_triplane', 'viz dumps'),
        (FID, 'feed', 'inception feed'),
        (FID, 'summary', 'fid/kid summary (host)'),
        (FIDKID, 'summary', 'fid/kid summary (host)')])


def eval_entry(cfg, data_key, root, pkl, num_images, metric=True,
               viz=True):
    """The config's evaluation entry of ``data_key`` as a literal for
    ``--cfg-options``: batch 8, ``num_images`` images, the statistics
    pickle ``pkl``; without ``metric`` no FID / KID (host-bound: phase
    9's uncond run computes them), without ``viz`` no image dumps."""
    ev = copy.deepcopy(next(e for e in cfg.evaluation
                            if e['data'] == data_key))
    ev.update(feed_batch_size=8,
              viz_dir=str(root / f'viz_{data_key}') if viz else None)
    if metric:
        ev['metrics'].update(num_images=num_images, inception_pkl=str(pkl))
    else:
        ev['metrics'] = None
    return repr([dict(ev)])


def depth_cuts(config, reconstruction):
    """(``--cfg-options``, their printed cuts) cutting an evaluation's
    depth: a reconstruction's to EVAL_GUIDE_STEPS guided and
    EVAL_OPTIM_STEPS ``val_optim`` steps, a generation's to
    EVAL_DDIM_STEPS DDIM steps."""
    tcfg = Config.fromfile(str(config)).test_cfg
    cuts = {'num_timesteps': EVAL_GUIDE_STEPS if reconstruction
            else EVAL_DDIM_STEPS}
    if reconstruction:
        cuts['n_inverse_steps'] = EVAL_OPTIM_STEPS
    return ([f'test_cfg.{k}={v}' for k, v in cuts.items()],
            ''.join(f', test_cfg.{k} {tcfg[k]} -> {v}'
                    for k, v in cuts.items()))


def flat_arrays(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_arrays(tree[k])]
    return [tree]


def phase_eval(model, model_cpu, code, bitfield, dev, root):
    """Evaluation at full width: a synthetic SRN test set (8 scenes x 251
    views of 128^2 rendered from ``code``), a checkpoint of the seed-0
    model written and read back, the real-image Inception statistics, then
    the port's CLI (``ssdnerf_torch.test.main``) on ssdnerf_cars_uncond.py
    and ssdnerf_cars_recons1v.py, timed by stage; one scene's mesh at 128^3
    (``_save_scenes`` with ``save_mesh``); then the card against the CPU
    (:func:`phase_eval_card_vs_cpu`) on the same test set.  ``model`` and
    ``model_cpu`` are the seed-0 recons1v models of phase 8.  The test set
    (``root/cars_test``) and its statistics (``root/inception_stats.pkl``)
    stay in ``root`` for phase 10."""
    S = code.shape[0]
    out = {}
    per_ray = render_bytes_per_ray(model, code, bitfield)
    full = S * EVAL_VIEWS * EVAL_SIZE ** 2
    views = max(1, int(RENDER_BUDGET_GIB * 2 ** 30 / (S * EVAL_SIZE ** 2
                                                      * per_ray)))
    max_rays = -1 if views >= EVAL_VIEWS else views * EVAL_SIZE ** 2
    out.update(render_bytes_per_ray=per_ray,
               unchunked_render_peak_gib=per_ray * full / 2 ** 30,
               max_render_rays=max_rays)
    log(f'phase 9 render memory: {per_ray:.0f} B a ray (8 x 4 views); '
        f'{S} x {EVAL_VIEWS} views unchunked ({full} rays): '
        f'{out["unchunked_render_peak_gib"]:.1f} GiB predicted -> '
        + (f'test_cfg.max_render_rays={max_rays} ({views} views a scene a '
           f'chunk, {RENDER_BUDGET_GIB:.0f} GiB budget)' if max_rays > 0
           else 'no chunking'))
    data_dir = root / 'cars_test'
    render_s, write_s = write_srn_set(model, code, bitfield, data_dir,
                                      EVAL_VIEWS, chunk=min(views, 16))
    log(f'phase 9 test set: {S} scenes x {EVAL_VIEWS} views of '
        f'{EVAL_SIZE}x{EVAL_SIZE} '
        f'rendered in {render_s:.2f} s, {S * EVAL_VIEWS} PNGs written in '
        f'{write_s:.2f} s')

    # checkpoint round trip
    ckpt = str(root / 'seed0.ckpt')
    save_checkpoint(ckpt, model_cpu, iteration=0)
    back = init_model(Config.fromfile(str(CONFIG)), 'cpu', SEED + 11,
                      checkpoint=ckpt)
    want, got = model_state(model_cpu), model_state(back)
    want, got = flat_arrays(want), flat_arrays(got)
    same = len(want) == len(got) > 0 and all(
        np.array_equal(a, b) for a, b in zip(want, got))
    log(f'phase 9 checkpoint: {Path(ckpt).stat().st_size / 2 ** 20:.1f}'
        f' MiB written and read back through init_model(checkpoint=): '
        f'bitwise equal {same}')
    check(same, 'checkpoint round trip not bitwise')
    del back

    # the real-image statistics (ssdnerf_torch/tools/inception_stat.py),
    # the extractor's time apart from the PNG reads
    cfg = Config.fromfile(str(CONFIG))
    cache = root / 'cars_test_cache.pkl'
    data_opts = [f'data.{k}.{f}={v}' for k in ('val_uncond', 'val_cond')
                 for f, v in (('data_prefix', data_dir),
                              ('cache_path', cache))]
    extract = make_inception_extractor(None, device=dev)
    spent = []

    def timed_extract(imgs):
        t = time.perf_counter()
        feats = extract(imgs)
        spent.append(time.perf_counter() - t)
        return feats

    t0 = time.perf_counter()
    stats_set = build_dataset(dict(cfg.data.val_uncond,
                                   data_prefix=str(data_dir),
                                   cache_path=str(cache), load_imgs=True))
    stats = inception_stats(stats_set, timed_extract, log=lambda m: None)
    read_s = time.perf_counter() - t0 - sum(spent)
    pkl = root / 'inception_stats.pkl'
    with open(pkl, 'wb') as f:
        pickle.dump(stats, f)
    n = len(stats['feats_np'])
    out.update(png_read_per_s=n / read_s, stats_inception_s=sum(spent))
    log(f'phase 9 statistics (tools/inception_stat): {n} PNGs read in '
        f'{read_s:.2f} s ({n / read_s:.0f} a second, '
        f'{stats_set.decode_threads} threads), Inception features '
        f'{stats["feats_np"].shape} in {sum(spent):.2f} s')

    runs = {}
    for name, config, key, n in (
            ('uncond', CONFIG, 'val_uncond', S * EVAL_VIEWS),
            ('recons', CONFIG_RECONS, 'val_cond', S * (EVAL_VIEWS - 1))):
        # FID / KID on the uncond run only: their host work is the same
        # for both
        opts = data_opts + [
            'evaluation=' + eval_entry(Config.fromfile(str(config)), key,
                                       root, pkl, n,
                                       metric=name == 'uncond')]
        depth, depth_text = depth_cuts(config, name == 'recons')
        opts += depth
        if name == 'uncond':
            opts.append(f'test_cfg.save_dir={root / "save"}')
        if max_rays > 0:
            opts.append(f'test_cfg.max_render_rays={max_rays}')
        log(f'phase 9 {name}: python -m ssdnerf_torch.test '
            f'{config.relative_to(ROOT)} <ckpt> --cfg-options '
            + ' '.join(o.split('=')[0] for o in opts)
            + f' (reductions: feed_batch_size 32 -> 8, num_images '
            f'{n}' + (f', max_render_rays {max_rays}' if max_rays > 0
                      else '') + depth_text
            + ('' if name == 'uncond' else ', evaluation.metrics None')
            + ')')
        walls = {}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eval_stages(walls), mock_attr(
                feature_nets, 'make_lpips', timed_lpips(walls)):
            (log_vars, metrics), = test_cli.main(
                [str(config), ckpt, '--device', str(dev), '--seed',
                 str(SEED), '--cfg-options', *opts])
        torch.cuda.synchronize()
        walls['total'] = time.perf_counter() - t0
        launches = launch_counts()
        results = dict(log_vars, **{k: v for m in metrics
                                   for k, v in m.result_dict.items()})
        log(f'phase 9 {name} results: ' + ', '.join(
            f'{k} {v:.6g}' for k, v in results.items()))
        log(f'phase 9 {name} stages (wall s): ' + ', '.join(
            f'{k} {v:.3f}' if isinstance(v, float) else f'{k} {v}'
            for k, v in walls.items()))
        log(f'phase 9 {name} launches: {launches}')
        check(all(math.isfinite(v) for v in results.values()),
              f'{name}: metric values not finite')
        for kname in (EVAL_UNCOND if name == 'uncond' else EVAL_RECONS):
            check(launches[kname] > 0, f'kernel {kname} was not '
                  f'launched by the {name} evaluation')
        runs[name] = dict(results=results, stages=walls,
                          launches=launches)
    expect = {'code_rms', 'fid_substitute', 'kid_substitute'}
    check(expect <= set(runs['uncond']['results']), 'uncond keys')
    check({'test_psnr', 'test_ssim', 'test_lpips_substitute',
           'code_rms'} <= set(runs['recons']['results']),
          'recons keys')
    saved = sorted(p.name for p in (root / 'save').iterdir())
    check(saved == [f'{i:04d}.npz' for i in range(S)],
          f'save_dir holds {saved}')

    # one scene's mesh through the save path; random weights leave no
    # surface at the default threshold (10), so the threshold is the
    # 99th percentile of the scene's occupied density grid
    blob = np.load(root / 'save' / '0000.npz')
    grid = blob['density_grid'].astype(np.float32)
    thresh = float(np.quantile(grid[grid > 0], 0.99))
    tcfg = model.test_cfg
    model.test_cfg = dict(tcfg, save_mesh=True, mesh_resolution=MESH_RES,
                          mesh_threshold=thresh)
    try:
        t0 = time.perf_counter()
        _save_scenes(model, {'scene_id': [0], 'scene_name': ['0000']}, *[
            torch.from_numpy(blob[k][None]).to(dev) for k in (
                'code', 'density_grid', 'density_bitfield')], 1,
            str(root / 'mesh'))
        mesh_s = time.perf_counter() - t0
    finally:
        model.test_cfg = tcfg
    stl = (root / 'mesh' / '0000.stl').read_bytes()
    tris = int.from_bytes(stl[80:84], 'little')
    log(f'phase 9 mesh of scene 0000 at {MESH_RES}^3 (threshold '
        f'{thresh:.4g}): {tris} triangles, '
        f'{len(stl) / 2 ** 20:.1f} MiB STL in {mesh_s:.2f} s')
    check(tris > 0 and len(stl) == 84 + 50 * tris, 'mesh STL empty')
    out.update(runs=runs, mesh_triangles=tris, mesh_s=mesh_s,
               render_s=render_s, write_s=write_s)
    out['card_vs_cpu'] = phase_eval_card_vs_cpu(
        model_cpu, model, code, bitfield, data_dir, dev)
    # the shipped feed_batch_size, 32 scenes a batch: the val_step's and
    # the render chunk's peaks over what was allocated scale with the batch
    out['predicted_peak_gib_at_32'] = {
        k: 4 * max(v['stages']['val_step_peak_gib'],
                   v['stages']['render_peak_gib'])
        for k, v in runs.items()}
    log('phase 9 predicted peak at feed_batch_size 32 (4 x the batch-8 '
        'peak of val_step or render over what was allocated): ' + ', '.join(
            f'{k} {v:.1f} GiB' for k, v in out[
                'predicted_peak_gib_at_32'].items()))
    return out


@contextlib.contextmanager
def mock_attr(owner, attr, value):
    saved = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


class FedImages:
    """A metric that keeps the images ``evaluate_3d`` feeds it."""

    def __init__(self):
        self.imgs = []

    def feed(self, imgs, mode):
        self.imgs.append(np.array(imgs))


class FirstViews:
    """The first ``n`` test views of each scene of ``dataset``."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        item = dict(self.dataset[i])
        for k in ('test_imgs', 'test_poses', 'test_intrinsics',
                  'test_img_paths'):
            item[k] = item[k][:self.n]
        return item


def phase_eval_card_vs_cpu(model_cpu, model_dev, code, bitfield, data_dir,
                           dev):
    """The metrics and the Inception features of the same 8 renders (scene
    0) and targets (scene 1's images) on the card and on the CPU, then ``evaluate_3d`` of 1 scene and
    4 test views (recons1v cut down as phase 8's card-vs-CPU run: 2 guided
    steps, 1 ``val_optim`` step, 4096 rays) on both with the same draws.
    Tolerances (PERF.md, stated before the run): PSNR 1e-4 dB, SSIM 1e-5,
    LPIPS and features 1e-4 of the largest; ``evaluate_3d``: the images
    fed to the metric max 2e-2 / mean 1e-3 (phase 8's image tolerance),
    test_psnr 2e-2 dB, the other log vars 1e-3."""
    cond_view = Config.fromfile(str(CONFIG_RECONS)).data.val_cond[
        'specific_observation_idcs']
    dataset = ShapeNetSRN(data_prefix=str(data_dir),
                          specific_observation_idcs=cond_view)
    # renders of scene 0 against the images of scene 1 from the same poses
    item = dataset[1]
    target = torch.from_numpy(item['test_imgs'][:8]).permute(0, 3, 1, 2)
    poses = torch.from_numpy(item['test_poses'][:8])[None].to(dev)
    intr = torch.from_numpy(item['test_intrinsics'][:8])[None].to(dev)
    with torch.no_grad():
        img, _ = model_dev.render(code[:1], bitfield[:1], EVAL_SIZE,
                                  EVAL_SIZE, intr, poses)
    pred = (img[0].permute(0, 3, 1, 2).clamp(0, 1) * 255).round() / 255
    res = {}
    vals = {}
    for tag, d in (('card', dev), ('cpu', 'cpu')):
        p, t = pred.to(d), target.to(d)
        lp = make_lpips(None, device=d)
        ext = make_inception_extractor(None, device=d)
        vals[tag] = dict(
            psnr=eval_psnr(p, t).cpu().numpy(),
            ssim=eval_ssim_skimage(p, t).cpu().numpy(),
            lpips=lp(p, t).cpu().numpy(),
            features=ext((p * 255).round().to(torch.uint8).permute(
                0, 2, 3, 1).cpu().numpy()))
    ok = True
    for name, tol, rel in (('psnr', 1e-4, False), ('ssim', 1e-5, False),
                           ('lpips', 1e-4, True), ('features', 1e-4, True)):
        a, b = vals['card'][name], vals['cpu'][name]
        err = float(np.abs(a - b).max())
        if rel:
            err /= max(float(np.abs(b).max()), 1e-30)
        res[name] = dict(err=err, tol=tol)
        ok = ok and err <= tol
        log(f'phase 9 card vs cpu {name}: {err:.3e} (tol {tol:.0e}'
            + (' of the largest)' if rel else ')'))

    tcfg = dict(model_cpu.test_cfg, num_timesteps=2, n_inverse_steps=1,
                n_inverse_rays=4096)
    draws = None
    logs, fed = {}, {}
    for tag, model, d in (('card', model_dev, dev), ('cpu', model_cpu,
                                                     'cpu')):
        saved = model.test_cfg
        model.test_cfg = tcfg
        model.eval_mode()
        try:
            if draws is None:
                draws = model.val_draws(1, EVAL_SIZE ** 2, torch.Generator(
                    ).manual_seed(SEED + 12))
                draws['optim'][0]['t'] = torch.tensor(
                    [model.diffusion.num_timesteps // 2])
            metric = FedImages()
            t0 = time.perf_counter()
            logs[tag] = evaluate_3d(
                model, FirstViews(dataset, 4), batch_size=1,
                metrics=[metric], max_num_scenes=1, log_fn=lambda s: None,
                draws_fn=lambda i, data, d=d: to_device(draws, d))
            fed[tag] = np.concatenate(metric.imgs).astype(np.float64)
            log(f'phase 9 card vs cpu evaluate_3d {tag}: '
                f'{time.perf_counter() - t0:.2f} s; {logs[tag]}')
        finally:
            model.train_mode()
            model.test_cfg = saved
    diff = np.abs(fed['card'] - fed['cpu'])
    for name, err, tol in (('fed image max abs', diff.max(), 2e-2),
                           ('fed image mean abs', diff.mean(), 1e-3)):
        res[name] = dict(err=float(err), tol=tol)
        ok = ok and err <= tol
        log(f'phase 9 card vs cpu evaluate_3d {name}: {err:.3e} (tol '
            f'{tol:.0e})')
    for key in logs['cpu']:
        tol = 2e-2 if key == 'test_psnr' else 1e-3
        err = abs(logs['card'][key] - logs['cpu'][key])
        res[key] = dict(err=err, tol=tol)
        ok = ok and err <= tol
        log(f'phase 9 card vs cpu evaluate_3d {key}: {err:.3e} (tol '
            f'{tol:.0e})')
    check(set(logs['card']) == set(logs['cpu']) == {
        'test_psnr', 'test_ssim', 'test_lpips_substitute', 'code_rms'},
        'evaluate_3d log var keys')
    check(ok, 'phase 9 card vs cpu')
    return res


# ------------------------------------------------------------- phase 10
TRAIN_SCENES = 16           # the bank of phase 10 (the flagship's: 2458)
TRAIN_VIEWS = 50            # views a training scene (SRN cars_train's)
# run a: checkpoints at 6 and 12; run b: 6, then resumed to 12; the
# updater's steps before the resume (2, 4) and after it (9)
TRAIN_ITERS, CKPT_EVERY, RESUME_AT = 12, 6, 6
UPDATER_STEPS = (2, 4, 9)
# |resumed - uninterrupted| / |uninterrupted| of each loss at every
# iteration after the resume (stated before the first run): the card's
# atomics make the runs differ by rounding, which a flipped occupancy bit
# or an Adam sign in a code moves by far less than this
RESUME_LOSS_TOL = 1e-2
LOSS_KEYS = ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'reg_loss')


def cut(cuts, key, old, new):
    cuts.append(f'{key} {old!r} -> {new!r}')
    return new


def phase10_config(root, run, max_rays, evaluate=True):
    """configs/paper_cfgs/ssdnerf_cars_uncond.py with phase 10's cuts (each
    listed), its data under ``root`` and its outputs under ``root/run``,
    written as ``root/<run>.py``.  Returns (path, cuts, cfg)."""
    cfg = Config.fromfile(str(CONFIG))
    work = root / run
    cuts = []
    cfg.model.cache_size = cut(cuts, 'model.cache_size',
                               cfg.model.cache_size, TRAIN_SCENES)
    cfg.total_iters = cut(cuts, 'total_iters', cfg.total_iters, TRAIN_ITERS)
    cfg.checkpoint_config.interval = cut(
        cuts, 'checkpoint_config.interval', cfg.checkpoint_config.interval,
        CKPT_EVERY)
    cfg.log_config.interval = cut(cuts, 'log_config.interval',
                                  cfg.log_config.interval, 1)
    for hook in cfg.custom_hooks:
        if hook.type == 'ModelUpdaterHook':
            hook.step = cut(cuts, 'ModelUpdaterHook.step', hook.step,
                            list(UPDATER_STEPS))
        if hook.type == 'SaveCacheHook':
            hook.update(out_dir=str(work / 'code'), viz_dir=str(work / 'viz'))
    # the flagship reads its bank back from SaveCache's out_dir
    cfg.train_cfg.cache_load_from = str(work / 'code')
    cfg.data.train.update(data_prefix=str(root / 'cars_train'),
                          cache_path=str(root / 'cars_train_cache.pkl'))
    cfg.data.val_uncond.update(data_prefix=str(root / 'cars_test'),
                               cache_path=str(root / 'cars_test_cache.pkl'))
    if max_rays > 0:
        cfg.test_cfg.max_render_rays = max_rays
    if evaluate:
        ev = cfg.evaluation[0]
        ev.interval = cut(cuts, 'evaluation.interval', ev.interval,
                          TRAIN_ITERS)
        ev.feed_batch_size = cut(cuts, 'evaluation.feed_batch_size',
                                 ev.feed_batch_size, 8)
        # FID / KID (host-bound sqrtm and kernel sums) run in phase 9
        ev.metrics = cut(cuts, 'evaluation.metrics', ev.metrics.type, None)
        cfg.test_cfg.num_timesteps = cut(
            cuts, 'test_cfg.num_timesteps', cfg.test_cfg.num_timesteps,
            EVAL_DDIM_STEPS)
        ev.viz_dir = str(work / 'viz_uncond')
    else:
        cfg.evaluation = cut(cuts, 'evaluation', '[...]', [])
    path = root / f'{run}.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return path, cuts, cfg


def train_cli(cfg_path, work, dev, *args):
    """The train CLI's entry (``ssdnerf_torch.train.main``, what ``python
    -m ssdnerf_torch.train`` runs) in this process on ``dev``, with the
    launch counts set to 0 just before and torch's TF32 switches as a
    fresh process has them; what it prints goes to ``work/cli.log``.
    Returns (wall s, its Timing summary, its kernel launches (printed on
    a card), what it printed)."""
    argv = [str(cfg_path), '--work-dir', str(work), '--seed', str(SEED),
            '--device', str(dev), *args]
    printed, runner = io.StringIO(), None
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with fresh_process_tf32(), contextlib.redirect_stdout(printed):
            runner = train_main(argv)
    except BaseException:
        log(printed.getvalue()[-5000:])
        raise
    finally:
        work.mkdir(parents=True, exist_ok=True)
        (work / 'cli.log').write_text(printed.getvalue())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del runner
    torch.cuda.empty_cache()
    stdout = printed.getvalue()
    timing = json.loads(re.findall(r'Timing: (\{.*\})', stdout)[-1])
    launches = [json.loads(x) for x in re.findall(
        r'kernel launches: (\{.*\})', stdout)]
    return wall, timing, launches[-1] if launches else {}, stdout


def read_stats(work):
    with open(work / 'stats_rank0.jsonl') as f:
        return {s['iter']: s for s in map(json.loads, f)}


def same_run(ref, got, iters, what, keys=LOSS_KEYS):
    """Each iteration of ``iters``: the same batch, every loss of ``keys``
    of ``got`` finite and within RESUME_LOSS_TOL of ``ref``'s (a NaN
    fails).  Returns the largest relative error."""
    errs = []
    for it in iters:
        check(got[it]['scene_id'] == ref[it]['scene_id'],
              f'{what}: iteration {it} trained another batch')
        for k in keys:
            check(math.isfinite(got[it][k]),
                  f'{what}: {k} at iteration {it} is {got[it][k]}')
            errs.append(abs(got[it][k] - ref[it][k]) / abs(ref[it][k]))
    worst = max(errs)
    log(f'{what}: same batches at iterations {iters[0]}-'
        f'{iters[-1]}; largest relative loss difference {worst:.3e} (tol '
        f'{RESUME_LOSS_TOL:.0e})')
    check(all(e <= RESUME_LOSS_TOL for e in errs), f'{what}: losses differ')
    return worst


def ess_at(it):
    """The flagship's extra_scene_step at (1-based) iteration ``it`` under
    phase 10's updater steps."""
    return 15 if it <= UPDATER_STEPS[0] else 3 if it <= UPDATER_STEPS[1] \
        else 1


def trees_equal(a, b):
    fa, fb = flat_arrays(a), flat_arrays(b)
    return len(fa) == len(fb) > 0 and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


def write_train_set(model, code, bitfield, root):
    """A synthetic SRN-layout ``root/cars_train``: 16 scenes x 50 views of
    128^2 at SRN intrinsics, ``model``'s renders of the 8 scenes of
    ``code`` twice (phase 9's writer)."""
    render_s, write_s = write_srn_set(
        model, torch.cat([code, code]), torch.cat([bitfield, bitfield]),
        root / 'cars_train', TRAIN_VIEWS, chunk=10)
    log(f'phase 10 cars_train: {TRAIN_SCENES} scenes (phase 3\'s 8 twice) x '
        f'{TRAIN_VIEWS} views of {EVAL_SIZE}x{EVAL_SIZE}: rendered in '
        f'{render_s:.2f} s, PNGs written in {write_s:.2f} s')


def phase_train_cli(dev, root, max_rays):
    """Training through the CLI at flagship width on ``root/cars_train``
    (:func:`write_train_set`): ``python -m ssdnerf_torch.train`` on the
    flagship config with phase 10's cuts, a run of TRAIN_ITERS iterations
    ending in the eval hook (on phase 9's ``root/cars_test``), a run of
    RESUME_AT and its resume to TRAIN_ITERS; then in-process a resume of
    the same checkpoint, its reloaded state held bitwise against the
    files, trained to TRAIN_ITERS with the launch counts set to 0 just
    before, then :func:`phase_sync_cost`'s legs."""
    out = {}
    t_phase = time.perf_counter()
    cfg_a, cuts, _ = phase10_config(root, 'run_a', max_rays)
    cfg_b, _, _ = phase10_config(root, 'run_b', max_rays, evaluate=False)
    log('phase 10 config: configs/paper_cfgs/ssdnerf_cars_uncond.py '
        'unchanged in every width; cuts: ' + '; '.join(cuts)
        + ('' if max_rays <= 0 else f'; test_cfg.max_render_rays '
           f'{max_rays} (phase 9\'s render chunk)')
        + '; run b: evaluation [] (the eval hook runs in run a only)')
    out['cuts'] = cuts

    runs = {}
    for name, cfg_path, args in (
            ('a', cfg_a, ()),
            (f'b{RESUME_AT}', cfg_b, ('--max-iters', str(RESUME_AT))),
            ('b_resumed', cfg_b, ('--resume-from', str(
                root / 'run_b' / 'ckpt' / f'iter_{RESUME_AT}.ckpt')))):
        work = root / ('run_a' if name == 'a' else 'run_b')
        wall, timing, launches, stdout = train_cli(cfg_path, work, dev,
                                                   *args)
        runs[name] = dict(wall_s=wall, timing=timing, launches=launches)
        hook_s = {k: v for k, v in timing['hook_s'].items() if '.' not in k}
        log(f'phase 10 run {name}: ssdnerf_torch.train.main '
            f'{cfg_path.name} {" ".join(args)}: {wall:.1f} s wall; '
            f'{timing["iterations"]} iterations {timing["total_iter_s"]:.2f}'
            f' s (first {timing.get("first_iter_s", 0):.3f} s; median '
            f'{timing.get("median_iter_s", 0):.4f}, quartiles '
            f'{timing.get("p25_iter_s", 0):.4f}-'
            f'{timing.get("p75_iter_s", 0):.4f}'
            f', min {timing.get("min_iter_s", 0):.4f}, max '
            f'{timing.get("max_iter_s", 0):.4f}); hooks (s): '
            + ', '.join(f'{k} {v:.3f}' for k, v in hook_s.items())
            + f'; resume {timing["resume_s"]}; peak '
            f'{timing.get("peak_gib", 0):.2f} GiB; launches {launches}')
        if name == 'a':
            for line in stdout.splitlines():
                if 'ModelUpdaterHook' in line or 'Eval:' in line:
                    log(f'phase 10 run a: {line}')
            runs[name]['updates'] = [
                int(m) for m in re.findall(
                    r'ModelUpdaterHook applied at iter (\d+)', stdout)]
            runs[name]['eval'] = {
                k: float(v) for k, v in re.findall(
                    r'(\w+)=([-+\w.]+)', re.findall(r'Eval: (.*)',
                                                    stdout)[-1])}

    timing = runs['a']['timing']
    hooks = {k: v for k, v in timing['hook_s'].items() if '.' not in k}
    out['hooks_share'] = sum(hooks.values()) / timing['total_iter_s']
    out['ema_ms_an_iteration'] = 1e3 * hooks['EMAHook'] / TRAIN_ITERS
    log(f'phase 10 run a summary: iteration wall median '
        f'{timing["median_iter_s"]:.4f} s (iterations 2-{TRAIN_ITERS}; '
        f'quartiles {timing["p25_iter_s"]:.4f}-{timing["p75_iter_s"]:.4f}); '
        f'hooks {sum(hooks.values()):.2f} s = {out["hooks_share"]:.1%} of '
        f'the iterations\' {timing["total_iter_s"]:.2f} s (EMA '
        f'{out["ema_ms_an_iteration"]:.2f} ms an iteration, checkpoints '
        f'{hooks["CheckpointHook"]:.2f} s, eval '
        f'{hooks["GenerativeEvalHook3D"]:.2f} s); resume (run b) '
        f'{runs["b_resumed"]["timing"]["resume_s"]:.2f} s; peak '
        f'{timing.get("peak_gib", float("nan")):.2f} GiB')

    a_dir, b_dir = root / 'run_a', root / 'run_b'
    sa, sb = read_stats(a_dir), read_stats(b_dir)
    check(sorted(sa) == list(range(1, TRAIN_ITERS + 1)), 'run a iterations')
    check(sorted(sb) == list(range(1, TRAIN_ITERS + 1)), 'run b iterations')
    check(all(math.isfinite(s[k]) for s in sa.values() for k in LOSS_KEYS),
          'run a: a loss is not finite')
    out['b_vs_a'] = same_run(sa, sb, list(range(1, RESUME_AT + 1)),
                             'phase 10 run b vs run a')
    out['resumed_vs_a'] = same_run(
        sa, sb, list(range(RESUME_AT + 1, TRAIN_ITERS + 1)),
        'phase 10 resumed run b vs run a')
    check(runs['b_resumed']['timing']['resume_s'] is not None,
          'run b did not resume')

    # files
    ckpt = a_dir / 'ckpt'
    want = [f'iter_{i}{s}' for i in (TRAIN_ITERS - CKPT_EVERY, TRAIN_ITERS)
            for s in ('.ckpt', '_cache_rank0.npz')] + ['latest.ckpt']
    check(sorted(p.name for p in ckpt.iterdir()) == sorted(want),
          f'run a checkpoints {sorted(p.name for p in ckpt.iterdir())}')
    check((ckpt / 'latest.ckpt').resolve().name == f'iter_{TRAIN_ITERS}.ckpt',
          'latest.ckpt')
    codes = sorted(p.name for p in (a_dir / 'code').iterdir())
    check(codes == [f'car_{s:04d}.npz' for s in range(TRAIN_SCENES)],
          f'SaveCache files {codes}')
    for d in (a_dir / 'viz', a_dir / 'viz_uncond'):
        check(any(d.iterdir()), f'{d.name} empty')
    mib = (ckpt / f'iter_{TRAIN_ITERS}.ckpt').stat().st_size / 2 ** 20
    state, it, _ = read_checkpoint(str(ckpt / f'iter_{TRAIN_ITERS}.ckpt'))
    check(it == TRAIN_ITERS and {'opt_diffusion', 'opt_decoder'} <= set(
        state), 'checkpoint iteration or optimizer groups')
    saves = TRAIN_ITERS // CKPT_EVERY
    out['checkpoint'] = dict(
        mib=mib, saves=saves,
        s_each=timing['hook_s']['CheckpointHook'] / saves,
        mib_model_groups=sum(a.nbytes for k in (
            'decoder', 'decoder_ema', 'diffusion', 'diffusion_ema',
            'ddpm_loss') for a in flat_arrays(state[k])) / 2 ** 20)
    log(f'phase 10 checkpoint: {mib:.1f} MiB with the optimizer groups '
        f'({out["checkpoint"]["mib_model_groups"]:.1f} MiB of model groups);'
        f' {out["checkpoint"]["s_each"]:.2f} s a save ({saves} in run a, '
        'with the bank .npz and pruning)')

    # the updater: its steps fired, and extra_scene_step and freeze_norm
    # show in the bank's Adam counts and the frozen norm factor
    check(runs['a']['updates'] == list(UPDATER_STEPS),
          f'updater fired at {runs["a"]["updates"]}')
    with np.load(ckpt / f'iter_{TRAIN_ITERS}_cache_rank0.npz') as blob:
        steps = blob['step']
    expect = np.zeros(TRAIN_SCENES, np.int64)
    for it, s in sa.items():
        expect[s['scene_id']] += ess_at(it) + 1
    check(np.array_equal(steps, expect), f'bank Adam counts {steps} vs '
          f'{expect} (extra_scene_step 15 -> 3 -> 1)')

    # eval hook
    ev = runs['a']['eval']
    check('code_rms' in ev and all(math.isfinite(v) for v in ev.values()),
          f'eval {ev}')
    for name in TRAIN:
        check(runs['a']['launches'][name] > 0, f'kernel {name} was not '
              'launched by the CLI run')

    # in-process: the resume's reloaded state, bitwise, then 10 iterations
    cfg_c, _, _ = phase10_config(root, 'run_c', max_rays, evaluate=False)
    runner = build_runner(Config.fromfile(str(cfg_c)), str(root / 'run_c'),
                          seed=SEED, device=str(dev))
    try:
        # the runner's fresh model: the initial weights of every run (a
        # copy: on the CPU the state's arrays share the live tensors)
        init = copy.deepcopy(model_state(runner.model))
        src = b_dir / 'ckpt' / f'iter_{RESUME_AT}.ckpt'
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.resume(str(src))
        resume_s = time.perf_counter() - t0
        saved = read_checkpoint(str(src))[0]
        back = model_state(runner.model, runner.optimizers, runner.schedulers)
        with np.load(b_dir / 'ckpt' / f'iter_{RESUME_AT}_cache_rank0.npz') \
                as blob:
            bank_same = all(np.array_equal(v, blob[k]) for k, v in
                            runner.cache.state_dict().items())
        same = trees_equal(saved, back)
        log(f'phase 10 resume in-process: {resume_s:.2f} s; reloaded state '
            f'bitwise equal to iter_{RESUME_AT}.ckpt {same}, bank to its '
            f'.npz {bank_same}')
        check(same and bank_same, 'resumed state differs from the files')
        reset_launches()
        torch.cuda.synchronize()
        runner.run()
        torch.cuda.synchronize()
        launches = launch_counts()
        norm_end = runner.model.diffusion.norm_factor.detach().float(
            ).cpu().numpy().copy()
        out['sync_cost'] = phase_sync_cost(runner)
    finally:
        runner.data_loader.close()
    m = runner.model
    got = dict(ess=m.train_cfg['extra_scene_step'], freeze=m.freeze_norm,
               pack=(m.decoder.pack_slots, m.decoder_ema.pack_slots),
               march=(m.decoder.march_slots, m.decoder_ema.march_slots),
               lr=m.train_cfg['optimizer']['lr'],
               pixel=m.pixel_loss.loss_weight, reg=m.reg_loss.loss_weight)
    cfg = Config.fromfile(str(CONFIG))
    before = dict(ess=cfg.train_cfg.extra_scene_step, freeze=False,
                  pack=(cfg.model.decoder.get('pack_slots'),) * 2,
                  march=(cfg.model.decoder.get('march_slots'),) * 2,
                  lr=cfg.train_cfg.optimizer.lr,
                  pixel=cfg.model.pixel_loss.loss_weight,
                  reg=cfg.model.reg_loss.loss_weight)
    log(f'phase 10 in-process run {RESUME_AT} -> {TRAIN_ITERS}: launches '
        f'{launches}; updater '
        f'settings before {before}, after {got}')
    check(got == dict(ess=1, freeze=True, pack=(512, 512), march=(128, 128),
                      lr=2.5e-3, pixel=10.0, reg=1.5e-3)
          and all(got[k] != before[k] for k in got), 'updater settings')
    for name in TRAIN:
        check(launches[name] > 0, f'kernel {name} was not launched by the '
              'in-process run')

    # run a's EMA moved away from both the live and the initial weights
    for name in ('diffusion', 'decoder'):
        ema, live, first = (flat_arrays(t[name + s]) for t, s in (
            (state, '_ema'), (state, ''), (init, '')))
        gap_live = max(np.abs(a - b).max() for a, b in zip(ema, live))
        gap_init = max(np.abs(a - b).max() for a, b in zip(ema, first))
        log(f'phase 10 {name}_ema: max |ema - live| {gap_live:.3e}, max '
            f'|ema - initial| {gap_init:.3e}')
        check(gap_live > 0 and gap_init > 0, f'{name}_ema did not move')
    # the norm factor moves until freeze_norm (the updater's second step)
    # and holds from there: the initial one, run b's checkpoint, the
    # in-process run from it
    norm = {0: init['ddpm_loss'], RESUME_AT: saved['ddpm_loss'],
            TRAIN_ITERS: norm_end}
    log(f'phase 10 norm factor at iterations {sorted(norm)}: '
        + ', '.join(f'{float(norm[k][0]):.6f}' for k in sorted(norm)))
    check(np.array_equal(norm[RESUME_AT], norm[TRAIN_ITERS])
          and not np.array_equal(norm[0], norm[RESUME_AT]),
          f'freeze_norm from iteration {UPDATER_STEPS[1]}')
    out.update(runs=runs, resume_in_process_s=resume_s, launches=launches,
               wall_s=time.perf_counter() - t_phase)
    return out


class SyncHook(Hook):
    """Waits for the device: the runner's former wait after each hook."""

    def after_train_iter(self, runner):
        torch.cuda.synchronize()


SYNC_LEG = 3   # iterations a leg of phase_sync_cost


def phase_sync_cost(runner):
    """The host wall of an iteration with and without a device wait after
    each hook, on ``runner`` (trained to TRAIN_ITERS): four legs of SYNC_LEG
    iterations past the run, without, with, with, without, each timed
    from one wait for the device to the next.  The legs run the
    per-iteration hooks at the flagship's log interval (50), without the
    checkpoint and SaveCache hooks, which only write files at their
    intervals and at the end.  Returns the seconds an iteration of each
    leg."""
    flagship = Config.fromfile(str(CONFIG)).log_config.interval
    hooks = [h for h in runner.hooks
             if type(h).__name__ not in ('CheckpointHook', 'SaveCacheHook')]
    for h in hooks:
        if type(h).__name__ in ('TextLoggerHook', 'SaveStatsHook'):
            h.interval = flagship
    synced = [x for h in hooks for x in (h, SyncHook())]
    legs = {'without': [], 'with': []}
    for name in ('without', 'with', 'with', 'without'):
        runner.hooks = synced if name == 'with' else hooks
        runner.max_iters += SYNC_LEG
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
        legs[name].append((time.perf_counter() - t0) / SYNC_LEG)
    log('phase 10 device waits after each hook: iteration wall without '
        + ', '.join(f'{t:.4f}' for t in legs['without']) + ' s, with '
        + ', '.join(f'{t:.4f}' for t in legs['with']) + f' s ({SYNC_LEG} '
        f'iterations a leg, legs without / with / with / without; hooks '
        f'{[type(h).__name__ for h in hooks]}, log interval {flagship})')
    return legs


class LogVarsHook(Hook):
    """Keeps each iteration's scalar log vars."""
    priority = 95

    def __init__(self):
        self.logs = []

    def after_train_iter(self, runner):
        self.logs.append({k: float(v) for k, v in
                          runner.last_log_vars.items() if np.ndim(v) == 0})


RUNNER_SEEDS = (SEED + 30,)  # of the replayed draws


@contextlib.contextmanager
def occupancy(record=None, replay=None):
    """While open, each ``update_density_grid`` of the train step (the
    inner steps' and the decoder step's) appends the bitfield it made to
    ``record``, or gives back ``replay``'s next one in place of its own
    (on its device): a card run then marches the cells a CPU run
    marched."""
    made = ad_dn.update_density_grid

    def swap(*args, **kwargs):
        grid, bits, extra = made(*args, **kwargs)
        if record is not None:
            record.append(bits.cpu())
        if replay is not None:
            bits = replay.pop(0).to(bits.device)
        return grid, bits, extra

    mods = (ad_dn, ad_base, ad_ms)
    for mod in mods:
        mod.update_density_grid = swap
    try:
        yield
    finally:
        for mod in mods:
            mod.update_density_grid = made


@contextlib.contextmanager
def composite_taus(store):
    """While open, each composite of a render under autograd (the train
    step's) puts its valid samples' optical depths tau = sigma dt into
    ``store['tau']`` (host f32), the last one staying."""
    made = ops_packing.composite_rays

    def keep(sigmas, rgbs, dts, ts, valid, T_thresh=1e-4):
        if sigmas.requires_grad:
            store['tau'] = (sigmas * dts)[valid].detach().float().cpu()
        return made(sigmas, rgbs, dts, ts, valid, T_thresh)

    ops_packing.composite_rays = dec_renderer.composite_rays = keep
    try:
        yield
    finally:
        ops_packing.composite_rays = dec_renderer.composite_rays = made


def alpha_rounding(tau, dev):
    """The composite's alpha = 1 - exp(-tau) (the JAX package's formula)
    of ``tau`` in f32 on the card and on the CPU against f64's
    -expm1(-tau): each one's mean signed error over alpha, and the share
    of samples where the card's alpha is below the CPU's; and the same
    for f32's -expm1(-tau)."""
    exact = -torch.expm1(-tau.double())
    out = {}
    for name, fn in (('1 - exp(-tau)', lambda t: 1.0 - torch.exp(-t)),
                     ('-expm1(-tau)', lambda t: -torch.expm1(-t))):
        a = {d: fn(tau.to(d)).double().cpu() for d in ('cpu', dev)}
        out[name] = dict(
            card=((a[dev] - exact) / exact).mean().item(),
            cpu=((a['cpu'] - exact) / exact).mean().item(),
            card_below=(a[dev] < a['cpu']).double().mean().item(),
            card_above=(a[dev] > a['cpu']).double().mean().item())
    return out


def runner_state(model_cpu, tc, cfg, dataset, draws, dev, dtype, work,
                 record=None, replay=None, taus=None):
    """Runner iterations of ``model_cpu``'s copy on ``dev``, one for each
    of ``draws`` (replayed), with the flagship's EMA hook, the decode in
    ``dtype``, the bitfields made recorded or replayed as
    :func:`occupancy` does (and with ``taus`` a dict, the last render's
    optical depths kept, :func:`composite_taus`).  Returns the losses,
    weights, moments and bank, and the decoder's parameter names and
    sizes."""
    model = copy.deepcopy(model_cpu).to(dev)
    model.train_cfg = copy.deepcopy(tc)
    model.cache_size = TRAIN_SCENES
    opts, scheds = build_optimizers(model, cfg.optimizer, cfg.lr_config,
                                    max_iters=cfg.total_iters)
    logs = LogVarsHook()
    ema_cfg = next(h for h in cfg.custom_hooks
                   if h.type == 'ExponentialMovingAverageHook')
    loader = DataLoader(dataset, 1, seed=SEED)
    runner = Runner(
        model, model.make_cache(dev), loader, opts, scheds, str(work),
        len(draws), hooks=[build_hooks([dict(ema_cfg)])[0], logs],
        seed=SEED, draws_fn=lambda it, data: to_device(draws[it], dev))
    try:
        with decode_dtype(model, dtype), occupancy(
                record, None if replay is None else list(replay)), (
                composite_taus(taus) if taus is not None
                else contextlib.nullcontext()):
            runner.run()
    finally:
        loader.close()
    groups = module_groups(model)
    sd = runner.cache.state_dict()
    seen = sd['seen']
    return dict(
        logs=logs.logs,
        **{k: torch.cat([p.detach().reshape(-1).cpu() for p in
                         groups[k].parameters()])
           for k in ('diffusion', 'diffusion_ema', 'decoder', 'decoder_ema')},
        **{f'{k} {m}': torch.cat([opts[k].state[p][m].reshape(-1).cpu()
                                  for p in groups[k].parameters()])
           for k in ('diffusion', 'decoder')
           for m in ('exp_avg', 'exp_avg_sq')},
        **{f'bank {k}': torch.from_numpy(sd[k][seen]).float()
           for k in ('m', 'v')},
        code=sd['code_'][seen], bits=sd['density_bitfield'][seen],
        steps=sd['step'][seen],
        decoder_names=[(n, p.numel()) for n, p in
                       groups['decoder'].named_parameters()])


MASKED = "card, the CPU's bitfields"
# readings a flipped occupancy bit moves, and the sums over every sample
BANK_KEYS = ('bank m', 'bank v', 'code share > 1e-3 of the largest update')
SUMMED = ('decoder exp_avg', 'decoder exp_avg_sq')
STATE_KEYS = ('diffusion', 'diffusion_ema', 'decoder', 'decoder_ema',
              'diffusion exp_avg', 'diffusion exp_avg_sq', 'decoder exp_avg',
              'decoder exp_avg_sq', 'bank m', 'bank v')


def by_parameter(card, cpu, key):
    """``key``'s (a decoder moment's) largest difference, parameter by
    parameter, over the largest entry of all: (name, that share, the
    difference over the parameter's own largest entry), largest first."""
    scale = cpu[key].abs().max()
    rows, at = [], 0
    for name, n in cpu['decoder_names']:
        a, b = card[key][at:at + n], cpu[key][at:at + n]
        diff = (a - b).abs().max()
        rows.append((name, (diff / scale).item(),
                     (diff / b.abs().max()).item()))
        at += n
    return sorted(rows, key=lambda r: -r[1])


def card_vs_cpu_errors(card, cpu):
    """Each reading of :func:`phase_runner_card_vs_cpu`: the share of
    bitfield bits flipped, each iteration's losses (relative), the
    weights' and moments' largest difference over their largest entry,
    the codes' largest difference and the share of them more than 1e-3
    of the largest code apart."""
    check(np.array_equal(card['steps'], cpu['steps']), 'Adam counts')
    errs = {'bitfield flipped': (np.unpackbits(card['bits'])
                                 != np.unpackbits(cpu['bits'])).mean()}
    for i, (a, b) in enumerate(zip(card['logs'], cpu['logs'])):
        for k in LOSS_KEYS:
            errs[f'iter {i + 1} {k}'] = abs(a[k] - b[k]) / abs(b[k])
    for k in STATE_KEYS:
        errs[k] = ((card[k] - cpu[k]).abs().max()
                   / cpu[k].abs().max()).item()
    diff = np.abs(card['code'] - cpu['code'])
    errs['code max |card - cpu|'] = diff.max()
    errs['code share > 1e-3 of the largest update'] = (
        diff > 1e-3 * np.abs(cpu['code']).max()).mean()
    return errs


def phase_runner_card_vs_cpu(model_cpu, cfg, root, dev, iters=3):
    """3 runner iterations of one scene each (phase 6's size: 1 inner step,
    1024 rays) with the flagship's EMA hook, on the card and on the CPU,
    from the same weights with the same replayed draws, for each of
    RUNNER_SEEDS' draws and each decode dtype (bf16 as shipped, and
    ``compute_dtype`` 'float32'): the CPU run records its bitfields; the
    card runs once making its own and once marching the CPU's
    (:func:`occupancy`, the control for flipped bits).

    Limits, phase 6's unless said: the losses rel 1e-4, the weights and
    moments 1e-3 of their largest entry, the codes' share more than 1e-3
    of the largest apart 1e-3, the codes within 2 x lr x (Adam steps) of
    each other, Adam counts equal, bits flipped 0 with the CPU's bitfields
    and <= 1e-3 without.  Each reading of a run that made its own
    bitfields or ran in bf16, and the f32 decoder moments, are held to the
    larger of that limit and half the CPU's bf16-vs-f32 gap of the same
    draws (a run known to differ): a flipped bit moves the losses too.
    The decoder moments are led by the density head's bias, whose
    gradient sums every sample's: the composite's alpha = 1 - exp(-tau) in
    f32 (the JAX package's formula) rounds differently on the card and the
    CPU, which shifts every ray's colour the same way; on near-white
    pixels that is a few 1e-4 of each sample's density gradient, and the
    bias gathers it into ~1e-3 of the moments' largest entry with the same
    bitfields (each draws' breakdown and rounding are printed).  A flipped
    bit moves the bank's moments and codes where a ray crosses its cell,
    by up to their size: a run that made its own bitfields reports them,
    and the run with the CPU's holds them."""
    tc = dict(model_cpu.train_cfg, extra_scene_step=1, n_inverse_rays=1024,
              n_decoder_rays=1024)
    dataset = build_dataset(dict(type='ShapeNetSRN',
                                 data_prefix=str(root / 'cars_train')))
    P = TRAIN_VIEWS * EVAL_SIZE ** 2
    lr = tc['optimizer']['lr']
    res = {}
    for seed in RUNNER_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        saved, model_cpu.train_cfg = model_cpu.train_cfg, tc
        draws = []
        try:
            for _ in range(iters):
                d = model_cpu.train_draws(1, P, gen)
                # a mid timestep: the SNR weight of the last ones is 0
                d['t'] = torch.tensor(
                    [model_cpu.diffusion.num_timesteps // 2])
                draws.append(d)
        finally:
            model_cpu.train_cfg = saved
        outs, cpu_bits, taus = {}, {'bfloat16': [], 'float32': []}, {}
        for dtype, tag, d, record, replay in (
                (dt, tag, d, record, replay) for dt in cpu_bits
                for tag, d, record, replay in (
                    ('cpu', 'cpu', cpu_bits[dt], None),
                    ('card', dev, None, None),
                    (MASKED, dev, None, cpu_bits[dt]))):
            t0 = time.perf_counter()
            outs[dtype, tag] = runner_state(
                model_cpu, tc, cfg, dataset, draws, d, dtype,
                root / f'runner_{seed}_{len(outs)}', record, replay,
                taus if (dtype, tag) == ('float32', 'cpu') else None)
            log(f'phase 10 runner {tag} ({dtype}, draws {seed}): '
                f'{time.perf_counter() - t0:.2f} s for {iters} iterations')
        gap = card_vs_cpu_errors(outs['bfloat16', 'cpu'],
                                 outs['float32', 'cpu'])
        for (dtype, tag), card in outs.items():
            if tag == 'cpu':
                continue
            errs = card_vs_cpu_errors(card, outs[dtype, 'cpu'])
            masked = tag == MASKED
            what = f'{dtype}, {MASKED}' if masked else dtype
            row = {}
            for k, err in errs.items():
                limit = 1e-4 if k.startswith('iter ') else 1e-3
                if k == 'bitfield flipped':
                    tol = 0.0 if masked else 1e-3
                elif k == 'code max |card - cpu|':
                    tol = 2 * lr * card['steps'].max()
                elif k in BANK_KEYS and not masked:
                    tol = None
                elif dtype == 'bfloat16' or k in SUMMED or not masked:
                    tol = max(limit, 0.5 * gap[k])
                else:
                    tol = limit
                held = ('not held: flipped bits move it' if tol is None
                        else f'tol {tol:.3e}')
                log(f'phase 10 runner card vs cpu ({what}, draws {seed}) '
                    f'{k}: {err:.3e} ({held})')
                check(tol is None or err <= tol, f'runner card vs cpu '
                      f'({what}, draws {seed}): {k}')
                row[k] = dict(err=float(err),
                              tol=None if tol is None else float(tol))
            res[f'{what}, draws {seed}'] = row
        # where the f32 decoder moments differ with the same bitfields,
        # and the composite's rounding on the last render's samples
        rows = by_parameter(outs['float32', MASKED], outs['float32', 'cpu'],
                            'decoder exp_avg')
        log(f'phase 10 runner card vs cpu (float32, {MASKED}, draws {seed}) '
            'decoder exp_avg by parameter (difference over the largest '
            'entry; over the parameter\'s own): ' + ', '.join(
                f'{n} {a:.3e} ({b:.3e})' for n, a, b in rows[:3]))
        rounding = alpha_rounding(taus['tau'], dev)
        log(f'phase 10 composite alpha of the f32 CPU run\'s last render '
            f'({taus["tau"].numel()} samples, tau median '
            f'{taus["tau"].median().item():.3e}), mean signed error over '
            'alpha against f64: ' + '; '.join(
                f'{k}: card {v["card"]:.3e}, cpu {v["cpu"]:.3e}, card below '
                f'the cpu on {v["card_below"]:.3f} of samples, above on '
                f'{v["card_above"]:.3f}' for k, v in rounding.items()))
        res[f'float32 decoder exp_avg by parameter, draws {seed}'] = rows[:3]
        res[f'composite alpha rounding, draws {seed}'] = rounding
    return res


# ------------------------------------------------------------------ phase 11
STAGE1 = ROOT / 'configs' / 'paper_cfgs' / 'stage1_cars_recons16v.py'
STAGE1_16BIT = ROOT / 'configs' / 'new_cfgs' / 'stage1_cars_recons16v_16bit.py'
STAGE1_FILES = (ROOT / 'configs' / 'new_cfgs'
                / 'stage1_cars_recons16v_16bit_filesystem.py')
STAGE2 = ROOT / 'configs' / 'paper_cfgs' / 'stage2_cars_uncond.py'
S1_ITERS, S1_SAVE = 12, 6   # run (a); checkpoints and the updater at 6
S1_SHORT = 4                # runs (b), (c): one epoch of 16 scenes
S2_ITERS = 6                # run (d)
BANK_ROWS = 2458            # the SRN cars bank of the stage-1 configs
STAGE1_KERNELS = ('march', 'decode_bf16', 'decode_bwd_bf16')
STAGE2_KERNELS = ('attention', 'attention_bwd')
S1_LOSSES = ('loss', 'pixel_loss', 'reg_loss')


def phase11_config(src, root, run, iters, cuts, **over):
    """``src`` with phase 11's cuts (each listed in ``cuts``): the bank at
    phase 10's 16 scenes, ``iters`` iterations, checkpoints (and the
    updater's step, SaveCache and DirCopy) every ``S1_SAVE`` or at the
    end, a log line each iteration, no evaluation (the JAX package cannot
    evaluate a stage-1 model); its data ``root/cars_train`` and its
    outputs under ``root/run``; ``over`` (dotted keys) merged last, each a
    cut too.  Written as ``root/<run>.py``; returns (path, cfg)."""
    cfg = Config.fromfile(str(src))
    work = root / run
    every = min(S1_SAVE, iters)
    if cfg.model.get('cache_size', 0) > 0:
        cfg.model.cache_size = cut(cuts, 'model.cache_size',
                                   cfg.model.cache_size, TRAIN_SCENES)
    cfg.total_iters = cut(cuts, 'total_iters', cfg.total_iters, iters)
    cfg.checkpoint_config.interval = cut(
        cuts, 'checkpoint_config.interval', cfg.checkpoint_config.interval,
        every)
    cfg.log_config.interval = cut(cuts, 'log_config.interval',
                                  cfg.log_config.interval, 1)
    for hook in cfg.get('custom_hooks', []):
        if hook.type == 'ModelUpdaterHook':
            hook.step = cut(cuts, 'ModelUpdaterHook.step', hook.step,
                            [S1_SAVE])
        if hook.type == 'SaveCacheHook':
            hook.interval = cut(cuts, 'SaveCacheHook.interval',
                                hook.interval, every)
            hook.update(out_dir=str(work / 'code'),
                        viz_dir=str(work / 'viz'))
        if hook.type == 'DirCopyHook':
            hook.interval = cut(cuts, 'DirCopyHook.interval', hook.interval,
                                every)
            hook.update(in_dir=str(work / 'code'),
                        out_dir=str(work / 'code_bak'))
    if 'cache_load_from' in cfg.train_cfg:
        cfg.train_cfg.cache_load_from = str(work / 'code')
    if 'save_dir' in cfg.train_cfg:
        cfg.train_cfg.save_dir = str(work / 'code')
    if cfg.data.train.get('code_dir'):
        cfg.data.train.code_dir = str(work / 'code')
    cfg.data.train.update(data_prefix=str(root / 'cars_train'),
                          cache_path=str(root / 'cars_train_cache.pkl'))
    if cfg.get('evaluation'):
        cfg.evaluation = cut(cuts, 'evaluation', '[...]', [])
    for key, value in over.items():
        d = cfg
        for k in key.split('.')[:-1]:
            d = d[k]
        cut(cuts, key, d.get(key.split('.')[-1]), value)
    cfg.merge_from_dict(over)
    path = root / f'{run}.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return path, cfg


def log_cli_run(tag, cfg_path, args, wall, timing, launches, smi):
    hook_s = {k: round(v, 4) for k, v in timing['hook_s'].items()
              if '.' not in k}
    log(f'phase 11 {tag}: ssdnerf_torch.train.main {cfg_path.name} '
        f'{" ".join(args)}: {wall:.1f} s wall; {timing["iterations"]} '
        f'iterations {timing["total_iter_s"]:.3f} s (first '
        f'{timing.get("first_iter_s", 0):.4f} s; median '
        f'{timing.get("median_iter_s", 0):.4f}, quartiles '
        f'{timing.get("p25_iter_s", 0):.4f}-{timing.get("p75_iter_s", 0):.4f}'
        f', min {timing.get("min_iter_s", 0):.4f}, max '
        f'{timing.get("max_iter_s", 0):.4f}; CUDA events); hooks (s): '
        f'{hook_s}; peak {timing.get("peak_gib", 0):.2f} GiB; launches '
        f'{launches}; {smi}')


def stage1_stats(work, iters, what):
    stats = read_stats(work)
    check(sorted(stats) == list(range(1, iters + 1)), f'{what} iterations')
    check(all(math.isfinite(s[k]) for s in stats.values()
              for k in S1_LOSSES + ('train_psnr', 'code_rms')),
          f'{what}: a loss is not finite')
    return stats


def fails_at_first_init_code(src, root, run, dev, cuts):
    """``src`` as shipped (``init_from_mean`` with ``NormalizedTanhCode``)
    raises at its first iteration's init codes, as the JAX package does
    (ROADMAP section 3 item 13)."""
    cfg_path, _ = phase11_config(src, root, run, 1, cuts)
    runner = build_runner(Config.fromfile(str(cfg_path)), str(root / run),
                          seed=SEED, device=str(dev))
    try:
        runner.train_iter(next(iter(runner.data_loader)))
    except TypeError as e:
        check('item 13' in str(e), f'{run}: {e}')
        log(f'phase 11 {run}: as shipped, the first iteration raises as '
            f'the JAX package does: {str(e)[:90]}...')
        return
    finally:
        runner.data_loader.close()
    check(False, f'{run}: the shipped config trained')


def bank_gib(dev, cache_16bit, code_size, grid):
    """Bytes a row and GiB of one allocation of the full 2458-row bank
    (its tensors' sizes; the allocator's growth beside)."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    bank = DeviceSceneCache(BANK_ROWS, code_size, grid, dev, cache_16bit)
    nbytes = sum(getattr(bank, k).nbytes for k in bank.KEYS)
    grown = torch.cuda.memory_allocated(dev) - base
    del bank
    torch.cuda.empty_cache()
    return nbytes / BANK_ROWS, nbytes / 2 ** 30, grown / 2 ** 30


def phase_stage1_cli(dev, root, smi):
    """Phase 11 (a)-(d): stage-1 and two-stage training through the CLI on
    phase 10's ``root/cars_train`` (16 scenes x 50 views of 128^2), at the
    stage-1 configs' full widths (3 x 6 x 128^2 codes, a 64^3 grid, the
    64-wide decoder in bf16, batch 4, 4096 inverse and decoder rays) and
    stage 2's (the flagship UNet in f32, batch 8)."""
    out, cuts = dict(runs={}), {}
    t_phase = time.perf_counter()

    # (a) stage 1, 12 iterations; its resume from 6 in-process
    cuts['a'] = []
    cfg_a, _ = phase11_config(STAGE1, root, 's1_a', S1_ITERS, cuts['a'])
    log('phase 11 (a) config: configs/paper_cfgs/stage1_cars_recons16v.py '
        'unchanged in every width; cuts: ' + '; '.join(cuts['a']))
    wall, timing, launches, stdout = train_cli(cfg_a, root / 's1_a', dev)
    log_cli_run('(a) stage 1', cfg_a, (), wall, timing, launches, smi)
    out['runs']['a'] = dict(wall_s=wall, timing=timing, launches=launches)
    sa = stage1_stats(root / 's1_a', S1_ITERS, 'run (a)')
    psnr = [sa[i]['train_psnr'] for i in range(1, S1_ITERS + 1)]
    first, last = np.mean(psnr[:4]), np.mean(psnr[-4:])
    log(f'phase 11 (a) train_psnr by iteration: '
        + ', '.join(f'{p:.3f}' for p in psnr)
        + f'; mean of 1-4 {first:.3f} dB, of 9-12 {last:.3f} dB')
    check(last > first, 'run (a): train_psnr did not rise')
    for name in STAGE1_KERNELS:
        check(launches[name] > 0, f'run (a): kernel {name} not launched')
    check(launches['attention'] == 0, 'run (a) ran a UNet')
    ckpt_a = root / 's1_a' / 'ckpt'
    state_a = read_checkpoint(str(ckpt_a / f'iter_{S1_ITERS}.ckpt'))[0]
    check(set(state_a) == {'decoder', 'decoder_ema', 'opt_decoder',
                           'init_code'}, f'run (a) groups {sorted(state_a)}')
    mean_code = np.abs(state_a['init_code'])
    log(f'phase 11 (a) init_code: max |.| {mean_code.max():.3e}, mean '
        f'{mean_code.mean():.3e} (0 at the start)')
    check(mean_code.max() > 0, 'run (a): init_code did not move')
    with np.load(ckpt_a / f'iter_{S1_ITERS}_cache_rank0.npz') as blob:
        steps = blob['step']
    expect = np.zeros(TRAIN_SCENES, np.int64)
    for it, s in sa.items():
        expect[s['scene_id']] += (15 if it <= S1_SAVE else 3) + 1
    check(np.array_equal(steps, expect), f'run (a) bank Adam counts {steps} '
          f'vs {expect} (extra_scene_step 15 -> 3)')
    codes = sorted(p.name for p in (root / 's1_a' / 'code').iterdir())
    check(codes == [f'car_{s:04d}.npz' for s in range(TRAIN_SCENES)],
          f'run (a) SaveCache files {codes}')

    cfg_b, _ = phase11_config(STAGE1, root, 's1_b', S1_ITERS, [])
    runner = build_runner(Config.fromfile(str(cfg_b)), str(root / 's1_b'),
                          seed=SEED, device=str(dev))
    try:
        runner.resume(str(ckpt_a / f'iter_{S1_SAVE}.ckpt'))
        reset_launches()
        runner.run()
        resumed_launches = launch_counts()
    finally:
        runner.data_loader.close()
    out['resumed_vs_a'] = same_run(
        sa, read_stats(root / 's1_b'), list(range(S1_SAVE + 1, S1_ITERS + 1)),
        'phase 11 (a) resumed from 6 vs uninterrupted', S1_LOSSES)
    out['runs']['a_resumed'] = dict(timing=runner.timing_summary(),
                                    launches=resumed_launches)
    log(f'phase 11 (a) resume in-process: {runner.timing["resume_s"]:.2f} s;'
        f' launches 7-12 {resumed_launches}')

    # (b) the 16-bit bank and NormalizedTanhCode
    cuts['b'] = []
    fails_at_first_init_code(STAGE1_16BIT, root, 's1_16bit_shipped', dev, [])
    cfg_16, _ = phase11_config(STAGE1_16BIT, root, 's1_16bit', S1_SHORT,
                               cuts['b'], **{'model.init_from_mean': False})
    log('phase 11 (b) config: configs/new_cfgs/stage1_cars_recons16v_16bit.'
        'py; cuts: ' + '; '.join(cuts['b']))
    wall, timing, launches, _ = train_cli(cfg_16, root / 's1_16bit', dev)
    log_cli_run('(b) stage 1, 16-bit', cfg_16, (), wall, timing, launches,
                smi)
    out['runs']['b'] = dict(wall_s=wall, timing=timing, launches=launches)
    stage1_stats(root / 's1_16bit', S1_SHORT, 'run (b)')
    state_b = read_checkpoint(str(root / 's1_16bit' / 'ckpt'
                                  / f'iter_{S1_SHORT}.ckpt'))[0]
    act = state_b['code_act']
    log(f'phase 11 (b) NormalizedTanhCode running mean '
        f'{float(act["0"][0]):.6e}, var {float(act["1"][0]):.6e} (start 0, '
        f'0.25)')
    check(float(act['0'][0]) != 0 and float(act['1'][0]) != 0.25,
          'run (b): the running statistics did not move')
    with np.load(root / 's1_16bit' / 'ckpt'
                 / f'iter_{S1_SHORT}_cache_rank0.npz') as blob:
        dtypes = {k: str(blob[k].dtype) for k in ('code_', 'm', 'v')}
    check(dtypes == dict(code_='float16', m='float32', v='float32'),
          f'run (b) bank file dtypes {dtypes}')
    model_cfg = Config.fromfile(str(STAGE1_16BIT)).model
    cs, grid = tuple(model_cfg.code_size), model_cfg.grid_size
    row16, gib16, grown16 = bank_gib(dev, True, cs, grid)
    row32, gib32, grown32 = bank_gib(dev, False, cs, grid)
    layout16 = math.prod(cs) * 2 * 3 + 4 + grid ** 3 * 2 + grid ** 3 // 8
    log(f'phase 11 (b) {BANK_ROWS}-row bank on the card: 16-bit {row16:.0f} '
        f'B a row (layout {layout16}), {gib16:.3f} GiB ({grown16:.3f} '
        f'allocated); f32 {row32:.0f} B a row, {gib32:.3f} GiB '
        f'({grown32:.3f} allocated)')
    check(row16 == layout16, 'the 16-bit bank row')
    out['bank'] = dict(row_16bit=row16, gib_16bit=gib16, row_f32=row32,
                       gib_f32=gib32)

    # (c) the filesystem cache
    cuts['c'] = []
    fails_at_first_init_code(STAGE1_FILES, root, 's1_files_shipped', dev, [])
    cfg_fs, _ = phase11_config(STAGE1_FILES, root, 's1_files', S1_SHORT,
                               cuts['c'], **{'model.init_from_mean': False})
    log('phase 11 (c) config: configs/new_cfgs/'
        'stage1_cars_recons16v_16bit_filesystem.py; cuts: '
        + '; '.join(cuts['c']))
    wall, timing, launches, _ = train_cli(cfg_fs, root / 's1_files', dev)
    log_cli_run('(c) stage 1, filesystem cache', cfg_fs, (), wall, timing,
                launches, smi)
    out['runs']['c'] = dict(wall_s=wall, timing=timing, launches=launches)
    stage1_stats(root / 's1_files', S1_SHORT, 'run (c)')
    code_dir, bak = root / 's1_files' / 'code', root / 's1_files' / 'code_bak'
    names = sorted(p.name for p in code_dir.iterdir())
    check(names == [f'car_{s:04d}.npz' for s in range(TRAIN_SCENES)],
          f'run (c) scene files {names}')
    check(sorted(p.name for p in bak.iterdir()) == names and all(
        (code_dir / n).read_bytes() == (bak / n).read_bytes()
        for n in names), 'run (c): DirCopyHook copies differ')
    cfg_fs2, _ = phase11_config(STAGE1_FILES, root, 's1_files_reload',
                                S1_SHORT, [],
                                **{'model.init_from_mean': False})
    runner = build_runner(Config.fromfile(str(cfg_fs2)),
                          str(root / 's1_files_reload'), seed=SEED,
                          device=str(dev))
    step = runner.model.train_step
    made = {}

    def keep(*args, **kwargs):
        made['batch'], logs = step(*args, **kwargs)
        return made['batch'], logs

    runner.model.train_step = keep
    try:
        batch = next(iter(runner.data_loader))
        runner.train_iter(batch)
        runner.flush_scene_files()
        back = runner.load_scene_files(batch)
    finally:
        runner.data_loader.close()
    pairs = [(made['batch'][k], back[k]) for k in
             ('code_', 'density_grid', 'density_bitfield')] + [
        (getattr(made['batch']['opt'], k), getattr(back['opt'], k))
        for k in ('m', 'v', 'step')]
    check(all(torch.equal(a, b) for a, b in pairs),
          'run (c): the scene files do not reload to the step\'s state')
    log('phase 11 (c) the writers\' files of one iteration reload bit for '
        'bit to the step\'s state (codes, moments, counts, grids, bits); '
        f'{len(names)} files, DirCopyHook\'s copies equal')

    # (d) stage 2 on (a)'s codes and checkpoint
    cuts['d'] = []
    cfg_2, _ = phase11_config(
        STAGE2, root, 's2', S2_ITERS, cuts['d'],
        **{'model.pretrained': str(ckpt_a / 'latest.ckpt'),
           'data.train.code_dir': str(root / 's1_a' / 'code')})
    log('phase 11 (d) config: configs/paper_cfgs/stage2_cars_uncond.py '
        '(batch 8, the flagship UNet in f32); cuts: ' + '; '.join(cuts['d']))
    wall, timing, launches, _ = train_cli(cfg_2, root / 's2', dev)
    log_cli_run('(d) stage 2', cfg_2, (), wall, timing, launches, smi)
    out['runs']['d'] = dict(wall_s=wall, timing=timing, launches=launches)
    s2 = read_stats(root / 's2')
    check(sorted(s2) == list(range(1, S2_ITERS + 1)) and all(
        math.isfinite(s['loss_diffusion']) for s in s2.values()),
        'run (d) losses')
    for name in STAGE2_KERNELS:
        check(launches[name] > 0, f'run (d): kernel {name} not launched')
    state_2 = read_checkpoint(str(root / 's2' / 'ckpt'
                                  / f'iter_{S2_ITERS}.ckpt'))[0]
    same = {k: trees_equal(state_2[k], state_a[k]) for k in
            ('decoder', 'decoder_ema', 'init_code')}
    log(f'phase 11 (d) decoder, decoder_ema and init_code bitwise equal to '
        f'stage 1\'s: {same}; losses '
        + ', '.join(f'{s2[i]["loss_diffusion"]:.4f}'
                    for i in range(1, S2_ITERS + 1)))
    check(all(same.values()), 'run (d) changed stage 1\'s groups')
    check(not (root / 's2' / 'ckpt' / f'iter_{S2_ITERS}_cache_rank0.npz'
               ).exists(), 'run (d) wrote a bank')
    out['cuts'] = cuts
    out['wall_s'] = time.perf_counter() - t_phase
    return out


def phase_stage1_card_vs_cpu(root, dev):
    """Phase 11 (e): one stage-1 ``train_step`` of 1 scene (phase 6's
    size: 1 inner step, 1024 rays; the scene's 50 views of
    ``root/cars_train``) on the card and on the CPU with the same seeded
    weights, codes and draws, with ``TanhCode`` (stage1_cars_recons16v)
    and ``NormalizedTanhCode`` (its 16-bit variant), in bf16 (as shipped)
    and with ``compute_dtype`` 'float32'; the CPU run records its
    bitfields, the card runs once with its own and once with the CPU's
    (:func:`occupancy`).  Phase 6's limits: losses rel 1e-4, the code Adam
    moment and the decoder's gradient 1e-3 of their largest entry, and
    the activation's running statistics rel 1e-5; a run in bf16 or with
    its own bitfields to the larger of that and half the CPU's
    bf16-vs-f32 gap of the same quantity (phase 10's rule; a flipped bit
    moves them too).  Returns the launches of the f32 card steps."""
    dataset = ShapeNetSRN(str(root / 'cars_train'))
    sample = dataset[0]
    data = {k: torch.from_numpy(sample[k])[None] for k in
            ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    num_pixels = math.prod(data['cond_imgs'].shape[1:4])
    launches = {n: 0 for n in WRAPPERS}
    out = {}
    for src in (STAGE1, STAGE1_16BIT):
        model_cpu = init_model(str(src), 'cpu', SEED).train()
        model_cpu.train_cfg.update(extra_scene_step=1, n_inverse_rays=1024,
                                   n_decoder_rays=1024)
        act = type(model_cpu.code_activation).__name__
        gen = torch.Generator().manual_seed(SEED + 11)
        code_ = torch.randn((1,) + model_cpu.code_size, generator=gen) * 0.3
        draws = model_cpu.train_draws(1, num_pixels, gen)
        H = model_cpu.grid_size
        batch = dict(code_=code_,
                     density_grid=torch.zeros((1, H ** 3),
                                              dtype=torch.float16),
                     density_bitfield=torch.zeros((1, H ** 3 // 8),
                                                  dtype=torch.uint8))
        runs = {}
        for dtype in ('bfloat16', 'float32'):
            bits = []
            for tag, d, rec, rep in (('cpu', 'cpu', bits, None),
                                     ('card', dev, None, None),
                                     (MASKED, dev, None, bits)):
                model = copy.deepcopy(model_cpu).to(d)
                opts, scheds = build_optimizers(
                    model, dict(decoder=dict(type='Adam', lr=1e-3)))
                if d != 'cpu' and dtype == 'float32':
                    reset_launches()
                t0 = time.perf_counter()
                batch_d = to_device(batch, d)
                batch_d['opt'] = adam_init(batch_d['code_'])
                with decode_dtype(model, dtype), occupancy(
                        rec, None if rep is None else list(rep)):
                    res, logs = model.train_step(
                        batch_d, to_device(data, d), opts, scheds,
                        draws=to_device(draws, d))
                if d != 'cpu' and dtype == 'float32':
                    for n, c in launch_counts().items():
                        launches[n] += c
                runs[dtype, tag] = dict(
                    logs={k: v.item() for k, v in logs.items()},
                    code_m=res['opt'].m.cpu(),
                    decoder=module_grads(model.decoder).cpu(),
                    bits=res['density_bitfield'].cpu(),
                    act=None if model.code_act is None else torch.cat(
                        model.code_act).cpu())
                log(f'phase 11 (e) {act} {tag} ({dtype}): '
                    f'{time.perf_counter() - t0:.2f} s')
                del model
        errs = {}
        for dtype in ('bfloat16', 'float32'):
            cpu = runs[dtype, 'cpu']
            for tag in ('card', MASKED):
                card = runs[dtype, tag]
                flips = (np.unpackbits(card['bits'].numpy())
                         != np.unpackbits(cpu['bits'].numpy())).mean()
                loose = dtype == 'bfloat16' or tag == 'card'
                for k, lim in (('loss', 1e-4), ('pixel_loss', 1e-4),
                               ('reg_loss', 1e-4), ('code_m', 1e-3),
                               ('decoder', 1e-3), ('act', 1e-5)):
                    if k == 'act' and cpu['act'] is None:
                        continue

                    def rel(a, b):
                        if k in a['logs']:
                            return abs(a['logs'][k] - b['logs'][k]) / abs(
                                b['logs'][k])
                        return ((a[k] - b[k]).abs().max()
                                / b[k].abs().max()).item()

                    err = rel(card, cpu)
                    gap = rel(cpu, runs['float32', 'cpu'])
                    tol = max(lim, 0.5 * gap) if loose else lim
                    errs[f'{dtype} {tag} {k}'] = err
                    log(f'phase 11 (e) {act} {k} ({dtype}, {tag}): rel_err '
                        f'{err:.2e} (tol {tol:.2e}; bf16-vs-f32 gap on the '
                        f'cpu {gap:.2e}); bits flipped {flips:.2e}')
                    check(err <= tol, f'(e) {act} {dtype} {tag}: {k}')
                if tag == MASKED:
                    check(flips == 0, f'(e) {act}: replayed bitfield')
        out[act] = errs
    return launches, out


# ------------------------------------------------------------ phase 12
CONFIG_TILED = ROOT / 'configs' / 'new_cfgs' / 'ssdnerf_cars_recons1v_tiled.py'
TILED_ITERS = 6             # iterations of phase 12's CLI run
TILED_UPDATER = (2, 4, 5)   # its updater's steps (the config's 2000, ...)
TILED_GUIDE_STEPS = 3       # guided steps of (d)
# the kernels of the tiled reconstruction: the bf16 guide's (the 16x48
# level's attention in bf16, the others in f32) and val_optim's (f32)
TILED_RECONS = RECONS + RECONS_FP16


@contextlib.contextmanager
def attention_shapes(tally):
    """Counts in ``tally`` each attention kernel launch of the block by
    direction, operand dtype and (T, hd), at the library's entry
    (``_build.launch``; the wrappers keep their own counts)."""
    launch = _build.launch

    def counted(name, device, *args):
        if name.startswith('attention_'):
            direction = name.split('_')[1]
            dtype = 'bfloat16' if name.endswith('bf16') else 'float32'
            key = f'{direction} {dtype} T={args[-3]} hd={args[-2]}'
            tally[key] = tally.get(key, 0) + 1
        return launch(name, device, *args)

    _build.launch = counted
    try:
        yield
    finally:
        _build.launch = launch


def expected_shapes(passes, dtype_at_768):
    """The attention calls of ``passes`` UNet passes (forward or backward)
    of the tiled UNet at batch 8: TILED_PASS calls a pass, the 16x48
    level's in ``dtype_at_768``, the others in f32 (JAX's gate)."""
    out = {}
    for direction, n in passes.items():
        for (T, hd), calls in TILED_PASS.items():
            dt = dtype_at_768 if T == 768 else 'float32'
            key = f'{direction} {dt} T={T} hd={hd}'
            out[key] = out.get(key, 0) + n * calls
    return out


def phase_tiled_recons(model, data, dev):
    """Phase 12 (b): the tiled config's ``val_step`` ('guide_optim': 75
    guided DDIM steps of the bf16 UNet at 2^14 rays, then 25 ``val_optim``
    steps of 4 inverse steps with the f32 EMA UNet) on 8 scenes with one
    128^2 view each, between ``eval_mode`` and ``train_mode``; a render of
    4 other views; the walls of the guide and the optimisation, peak
    memory, the attention calls by shape and dtype (exactly those of 75
    forward and input-backward passes in bf16 autocast and 25 of each in
    f32), then one guided and one ``val_optim`` step under the profiler.
    Each of TILED_RECONS must launch."""
    tcfg = model.test_cfg
    cond, test = recons_inputs(data)
    S = cond['cond_imgs'].shape[0]
    num_pixels = math.prod(cond['cond_imgs'].shape[1:4])
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    model.eval_mode()
    walls, tally = {}, {}
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_ranges(model, walls), attention_shapes(tally):
        code, grid, bitfield = model.val_step(cond, generator=gen)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.train_mode()
    h, w = test['cond_imgs'].shape[2:4]
    img, depth = model.render(code, bitfield, h, w,
                              test['cond_intrinsics'], test['cond_poses'])
    psnrs = [psnr_db(img[i], test['cond_imgs'][i]) for i in range(S)]
    occ = np.unpackbits(bitfield.cpu().numpy()).mean()
    steps, optim = tcfg['num_timesteps'], tcfg['n_inverse_steps']
    log(f'phase 12 (b) reconstruction ({tcfg["cond_mode"]}, {S} scenes, 1 '
        f'view of 128x128, autocast {model.autocast_dtype}): val_step '
        f'{total_s:.3f} s = guide {walls["val_step.guide"]:.3f} s ({steps} '
        f'guided DDIM steps at {tcfg["n_inverse_rays"]} rays) + optim '
        f'{walls["val_step.optim"]:.3f} s ({optim} steps x '
        f'{tcfg["extra_scene_step"] + 1} inverse steps); peak memory '
        f'{peak:.2f} GiB; launches {launches}')
    log(f'phase 12 (b) attention calls by shape: {tally}')
    log(f'phase 12 (b) outputs: code {tuple(code.shape)} |code|max='
        f'{code.abs().max().item():.3f}; occupancy {occ:.4f}; render of '
        f'{len(RECONS_VIEWS)} other views PSNR (dB) mean '
        f'{statistics.mean(psnrs):.3f} (random weights: no bar)')
    check(code.shape == (S,) + model.code_size, 'tiled code shape')
    check(torch.isfinite(code).all().item(), 'tiled codes not finite')
    check(grid.dtype == torch.float16 and not torch.isnan(grid).any().item(),
          'tiled grid')
    for t in (img, depth):
        check(torch.isfinite(t).all().item(), 'tiled render not finite')
    for name in TILED_RECONS:
        check(launches[name] > 0, f'phase 12 (b): kernel {name} was not '
              'launched by the reconstruction')
    want = expected_shapes(dict(fwd=steps, bwd=steps), 'bfloat16')
    for key, n in expected_shapes(dict(fwd=optim, bwd=optim),
                                  'float32').items():
        want[key] = want.get(key, 0) + n
    check(tally == want, f'phase 12 (b): attention calls {tally} != {want}')
    check(tally.get('fwd bfloat16 T=768 hd=40', 0) > 0,
          'phase 12 (b): no bf16 attention at (768, 40)')

    model.test_cfg = dict(tcfg, num_timesteps=1, n_inverse_steps=1)
    try:
        draws = model.val_draws(S, num_pixels, gen, dev)
        profiles = {
            'guide': profile_step(lambda: model.val_guide(
                cond, draws['noise'], draws), ranges=('val_step.guide',)),
            'optim': profile_step(lambda: model.val_optim(
                cond, draws, code_=model.code_activation.inverse(
                    code, model.code_act),
                density_grid=grid, density_bitfield=bitfield),
                ranges=('val_step.optim',))}
    finally:
        model.test_cfg = tcfg
    for part, (wall_ms, dev_ms, _, groups, top) in profiles.items():
        log(f'phase 12 (b) profiled {part} step: wall {wall_ms:.1f} ms, '
            f'device {dev_ms:.1f} ms; by group: ' + ', '.join(
                f'{k} {v:.2f} ms ({v / dev_ms:.1%})'
                for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
        for name, (n, ms) in top[:6]:
            log(f'phase 12 (b) {part} kernel {ms:8.3f} ms x{n:4d} '
                f'{name[:90]}')
    check(profiles['guide'][3].get('attention_bwd_bf16', 0.0) > 0,
          'phase 12 (b): the bf16 attention backward read no device time '
          'in the profiled guided step')
    # device ms of one UNet forward at batch 8: the guide's bf16 copy and
    # val_optim's f32 EMA UNet
    g = torch.Generator().manual_seed(SEED + 42)
    x = torch.randn((S,) + model.code_diff_size, generator=g).to(dev)
    t = torch.randint(0, model.diffusion.num_timesteps, (S,),
                      generator=g).to(dev)
    unet_ms = {}
    for tag, unet, inp in (
            ('bf16', model.sampling_diffusion.denoising, x.bfloat16()),
            ('ieee_f32', model.ema_diffusion.denoising, x)):
        with torch.no_grad():
            unet_ms[tag] = sum(device_profile(lambda: unet(inp, t),
                                              3).values())
    log('phase 12 (b) tiled UNet forward (batch 8) device ms: ' + ', '.join(
        f'{k} {v:.2f}' for k, v in unet_ms.items()))
    return launches, dict(unet_forward_device_ms=unet_ms,
        val_step_s=total_s, range_wall_s=walls, peak_gib=peak,
        attention_calls=tally, psnr_db=psnrs, occupancy=occ,
        profiled={k: dict(wall_ms=v[0], device_ms=v[1],
                          device_ms_by_group=v[3])
                  for k, v in profiles.items()})


def phase12_config(root, run, cuts):
    """The tiled config with phase 12 (c)'s cuts (each listed in ``cuts``):
    bank 16 scenes, TILED_ITERS iterations, one checkpoint at the end, a
    log line each iteration, the updater at TILED_UPDATER, no evaluation;
    its data ``root/cars_train`` and its outputs under ``root/run``.
    Written as ``root/<run>.py``."""
    cfg = Config.fromfile(str(CONFIG_TILED))
    work = root / run
    cfg.model.cache_size = cut(cuts, 'model.cache_size', cfg.model.cache_size,
                               TRAIN_SCENES)
    cfg.total_iters = cut(cuts, 'total_iters', cfg.total_iters, TILED_ITERS)
    cfg.checkpoint_config.interval = cut(
        cuts, 'checkpoint_config.interval', cfg.checkpoint_config.interval,
        TILED_ITERS)
    cfg.log_config.interval = cut(cuts, 'log_config.interval',
                                  cfg.log_config.interval, 1)
    for hook in cfg.custom_hooks:
        if hook.type == 'ModelUpdaterHook':
            hook.step = cut(cuts, 'ModelUpdaterHook.step', hook.step,
                            list(TILED_UPDATER))
        if hook.type == 'SaveCacheHook':
            hook.update(out_dir=str(work / 'code'), viz_dir=str(work / 'viz'))
    cfg.train_cfg.cache_load_from = str(work / 'code')
    cfg.data.train.update(data_prefix=str(root / 'cars_train'),
                          cache_path=str(root / 'cars_train_cache.pkl'))
    cfg.evaluation = cut(cuts, 'evaluation', '[...]', [])
    path = root / f'{run}.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return path


def phase_tiled_cli(dev, root, smi):
    """Phase 12 (c): ``python -m ssdnerf_torch.train`` with the tiled
    config (phase12_config's cuts) on phase 10's ``root/cars_train``: every
    iteration logged with finite losses, the f32 attention kernels (the
    training UNet's, at the tiled levels) launched, the checkpoint and the
    bank's code file written."""
    cuts = []
    cfg_path = phase12_config(root, 'tiled', cuts)
    log('phase 12 (c) cuts of the tiled config (every width unchanged): '
        + '; '.join(cuts))
    work = root / 'tiled'
    wall, timing, launches, _ = train_cli(cfg_path, work, dev)
    hook_s = {k: round(v, 4) for k, v in timing['hook_s'].items()
              if '.' not in k}
    log(f'phase 12 (c): ssdnerf_torch.train.main {cfg_path.name}: '
        f'{wall:.1f} s wall; {timing["iterations"]} iterations '
        f'{timing["total_iter_s"]:.3f} s (first '
        f'{timing.get("first_iter_s", 0):.4f} s; median '
        f'{timing.get("median_iter_s", 0):.4f}, min '
        f'{timing.get("min_iter_s", 0):.4f}, max '
        f'{timing.get("max_iter_s", 0):.4f}; CUDA events); hooks (s): '
        f'{hook_s}; peak {timing.get("peak_gib", 0):.2f} GiB; launches '
        f'{launches}; {smi}')
    stats = read_stats(work)
    check(sorted(stats) == list(range(1, TILED_ITERS + 1)),
          'phase 12 (c): iterations logged')
    for s_ in stats.values():
        for k in LOSS_KEYS + ('train_psnr',):
            check(math.isfinite(s_[k]), f'phase 12 (c): {k} not finite')
    for name in TRAIN:
        check(launches.get(name, 0) > 0,
              f'phase 12 (c): kernel {name} was not launched')
    ckpt = work / 'ckpt'
    check((ckpt / f'iter_{TILED_ITERS}.ckpt').exists()
          and (ckpt / f'iter_{TILED_ITERS}_cache_rank0.npz').exists(),
          f'phase 12 (c): checkpoint files {sorted(ckpt.iterdir())}')
    return dict(wall_s=wall, timing=timing, launches=launches, cuts=cuts,
                losses={it: {k: stats[it][k] for k in LOSS_KEYS}
                        for it in stats},
                checkpoint=str(ckpt / f'iter_{TILED_ITERS}.ckpt'))


def phase_tiled_test_cli(dev, root, ckpt, max_rays):
    """Phase 12 (c), evaluation: ``python -m ssdnerf_torch.test`` (its
    ``main``) with the tiled config on (c)'s checkpoint and phase 9's
    ``root/cars_test`` (8 scenes: view 64 conditions 'guide_optim', the
    other 250 are rendered), with phase 9's cuts (batch 8, its render
    chunk); the metrics finite, the bf16 attention launched (the guide's
    16 x 48 level)."""
    cache = root / 'cars_test_cache.pkl'
    cfg = Config.fromfile(str(CONFIG_TILED))
    n = 8 * (EVAL_VIEWS - 1)
    opts = [f'data.val_cond.data_prefix={root / "cars_test"}',
            f'data.val_cond.cache_path={cache}',
            'evaluation=' + eval_entry(cfg, 'val_cond', root, None, n,
                                       metric=False, viz=False)]
    depth, depth_text = depth_cuts(CONFIG_TILED, True)
    opts += depth
    if max_rays > 0:
        opts.append(f'test_cfg.max_render_rays={max_rays}')
    log(f'phase 12 (c) evaluation: python -m ssdnerf_torch.test '
        f'{CONFIG_TILED.relative_to(ROOT)} <the checkpoint of (c)> '
        '--cfg-options '
        + ' '.join(o.split('=')[0] for o in opts)
        + f' (cuts: feed_batch_size 32 -> 8, num_images {n}'
        + (f', max_render_rays {max_rays}' if max_rays > 0 else '')
        + depth_text + ', evaluation.metrics None, evaluation.viz_dir None'
        ')')
    walls = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eval_stages(walls):
        (log_vars, metrics), = test_cli.main(
            [str(CONFIG_TILED), ckpt, '--device', str(dev), '--seed',
             str(SEED), '--cfg-options', *opts])
    torch.cuda.synchronize()
    walls['total'] = time.perf_counter() - t0
    launches = launch_counts()
    results = dict(log_vars, **{k: v for m in metrics
                                   for k, v in m.result_dict.items()})
    log('phase 12 (c) evaluation results: ' + ', '.join(
        f'{k} {v:.6g}' for k, v in results.items()))
    log('phase 12 (c) evaluation stages (wall s): ' + ', '.join(
        f'{k} {v:.3f}' if isinstance(v, float) else f'{k} {v}'
        for k, v in walls.items()) + f'; launches {launches}')
    check(all(math.isfinite(v) for v in results.values()),
          'phase 12 (c) evaluation: metric values not finite')
    check({'test_psnr', 'test_ssim', 'test_lpips_substitute'}
          <= set(results),
          'phase 12 (c) evaluation keys')
    for name in TILED_RECONS:
        check(launches[name] > 0, f'phase 12 (c) evaluation: kernel {name} '
              'was not launched')
    return dict(results=results, stages=walls, launches=launches)


def phase_tiled_guide_card_vs_cpu(model_cpu, data, dev):
    """Phase 12 (d), the guide: TILED_GUIDE_STEPS guided DDIM steps of 1
    scene (rays cut to 4096 a guided step, as phase 8 cuts them for the
    CPU) on the card and on the CPU under the config's bf16 autocast, and
    on the CPU without it, with the same weights and draws.  Phase 7's rule
    for a bf16 UNet: the card's codes within 1.25 x the CPU's bf16-vs-f32
    gap of the CPU's bf16 codes (relative L2) and at least half that gap
    from the f32 codes; the bitfields' flipped share within 1e-3 or 1.25 x
    the CPU's own bf16-vs-f32 share, where that is larger."""
    cond, _ = recons_inputs({k: v.cpu() for k, v in data.items()}, S=1)
    tcfg = dict(model_cpu.test_cfg, num_timesteps=TILED_GUIDE_STEPS,
                n_inverse_rays=4096, cond_mode='guide')
    saved = model_cpu.test_cfg
    model_cpu.test_cfg = tcfg
    try:
        draws = model_cpu.val_draws(
            1, math.prod(cond['cond_imgs'].shape[1:4]),
            torch.Generator().manual_seed(SEED + 41))
    finally:
        model_cpu.test_cfg = saved
    model_dev = copy.deepcopy(model_cpu).to(dev)
    outs = {}
    for tag, model, d, autocast in (('card', model_dev, dev, 'bfloat16'),
                                    ('cpu', model_cpu, 'cpu', 'bfloat16'),
                                    ('cpu f32', model_cpu, 'cpu', None)):
        t0 = time.perf_counter()
        saved, saved_ac = model.test_cfg, model.autocast_dtype
        model.test_cfg, model.autocast_dtype = tcfg, autocast
        model.eval_mode()
        try:
            dr = to_device(draws, d)
            code, _, bits = model.val_guide(to_device(cond, d), dr['noise'],
                                            dr)
        finally:
            model.train_mode()
            model.test_cfg, model.autocast_dtype = saved, saved_ac
        outs[tag] = (code.cpu(), bits.cpu())
        log(f'phase 12 (d) guide {tag}: {time.perf_counter() - t0:.2f} s')
    del model_dev

    def flipped(a, b):
        return float((np.unpackbits(a.numpy())
                      != np.unpackbits(b.numpy())).mean())

    (card, cbits), (cpu, pbits), (f32, fbits) = (
        outs['card'], outs['cpu'], outs['cpu f32'])
    err, gap, far = l2(card, cpu), l2(cpu, f32), l2(card, f32)
    flips, flip_gap = flipped(cbits, pbits), flipped(pbits, fbits)
    log(f'phase 12 (d) card vs cpu (bf16 autocast, {TILED_GUIDE_STEPS} '
        f'guided steps, 1 scene): codes rel_l2 {err:.3e} (tol 1.25 x gap '
        f'{gap:.3e}); card from f32 {far:.3e} (tol >= 0.5 x gap); bits '
        f'flipped {flips:.2e} (tol max(1e-3, 1.25 x the cpu\'s bf16-vs-f32 '
        f'{flip_gap:.2e}))')
    check(torch.isfinite(card).all().item(), 'phase 12 (d): guide codes')
    check(err <= 1.25 * gap and far >= 0.5 * gap,
          'phase 12 (d): card vs cpu guide codes')
    check(flips <= max(1e-3, 1.25 * flip_gap), 'phase 12 (d): bits')
    return dict(rel_l2=err, gap=gap, from_f32=far, bits_flipped=flips,
                bits_gap=flip_gap)


def phase_tiled(dev, root, data, code, smi, max_rays):
    """Phase 12: configs/new_cfgs/ssdnerf_cars_recons1v_tiled.py at every
    width (random seeded weights): (a) 4 timed train steps of 8 scenes with
    a 2458-row bank (phase 5's protocol); (b) ``val_step``
    (:func:`phase_tiled_recons`); (c) the train CLI
    (:func:`phase_tiled_cli`), then the evaluation CLI on its checkpoint
    (:func:`phase_tiled_test_cli`, phase 9's test set; ``max_rays`` its
    render chunk); (d) one train step (phase 6's rule; the f32
    decode only: the bf16 decode's rule is held by phase 6) and
    TILED_GUIDE_STEPS guided steps card vs CPU; (e) the flagship recons1v
    with ``image_cond`` (a UNet of 18 + 3 input channels): one train step
    and 2 guided steps + 1 ``val_optim`` step card vs CPU (phases 6 and 8,
    f32 decode)."""
    out = {}
    t_phase = time.perf_counter()
    cfg = Config.fromfile(str(CONFIG_TILED))
    model_cpu = make_model(SEED, CONFIG_TILED)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    unet = model_dev.diffusion.denoising
    log(f'phase 12 tiled config: codes {model_dev.code_size} laid out '
        f'{model_dev.code_diff_size} (code_permute '
        f'{model_dev.code_permute}); UNet image {unet.image_size}, levels '
        f'{len(unet.channels_cfg)}, attention at scales '
        f'{unet.attention_scale}, {sum(p.numel() for p in unet.parameters())}'
        f' parameters; autocast {model_dev.autocast_dtype}; cuts: none in '
        f'(a)-(b), (c) and (d)-(e) print theirs')
    tally = {}
    with attention_shapes(tally):
        train_launches, out['train'] = phase_train(model_dev, cfg, data, code,
                                                   dev, timed=4, phase=12)
    log(f'phase 12 (a) attention calls by shape over 6 steps: {tally}')
    check(tally == expected_shapes(dict(fwd=6, bwd=6), 'float32'),
          f'phase 12 (a): attention calls {tally}')
    torch.cuda.empty_cache()
    recons_launches, out['recons'] = phase_tiled_recons(model_dev, data, dev)
    del model_dev
    torch.cuda.empty_cache()
    out['cli'] = phase_tiled_cli(dev, root, smi)
    torch.cuda.empty_cache()
    out['test_cli'] = phase_tiled_test_cli(dev, root, out['cli']['checkpoint'],
                                           max_rays)
    torch.cuda.empty_cache()
    log('phase 12 (d) cut: the decode in f32 only (phase 6 holds the bf16 '
        f'decode card vs cpu); {TILED_GUIDE_STEPS} guided steps of 75')
    out['card_vs_cpu'] = dict(train_f32_launches=phase_train_card_vs_cpu(
        model_cpu, cfg, data, code, dev, phase=12, dtypes=('float32',)))
    out['card_vs_cpu']['guide'] = phase_tiled_guide_card_vs_cpu(
        model_cpu, data, dev)
    del model_cpu
    torch.cuda.empty_cache()
    cfg_ic = Config.fromfile(str(CONFIG_RECONS))
    cfg_ic.model.image_cond = True
    cfg_ic.model.diffusion.denoising.concat_cond_channels = 3
    ic_cpu = make_model(SEED, cfg_ic)
    ic_dev = copy.deepcopy(ic_cpu).to(dev)
    log('phase 12 (e) recons1v with image_cond (UNet in_conv over '
        f'{ic_dev.diffusion.denoising.in_conv.in_channels} channels); cut: '
        'the decode in f32 only')
    ic_launches = phase_train_card_vs_cpu(ic_cpu, cfg_ic, data, code, dev,
                                          phase=12, dtypes=('float32',))
    out['image_cond'] = dict(
        train_f32_launches=ic_launches,
        recons=phase_recons_card_vs_cpu(ic_cpu, ic_dev, data, dev,
                                        phase=12, dtypes=('float32',)))
    del ic_cpu, ic_dev
    torch.cuda.empty_cache()
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'phase 12: {out["phase_s"]:.1f} s')
    return train_launches, recons_launches, out


# ------------------------------------------------------------ phase 13
OPTIONS_RES = 128           # the views' side, as phase 5's
OPTIONS_ESS = 2             # (a)'s inner steps: a full refresh, a partial
OPTIONS_INVERSE_STEPS = 4   # (f)'s val_inverse_code steps (the config's 400)
OPTIONS_KERNELS = ('march', 'decode_bf16', 'decode_bwd_bf16', 'attention',
                   'attention_bwd', 'decode', 'decode_bwd')


def options_model(over):
    """The flagship model of :func:`make_model` with the dotted
    ``cfg-options`` ``over`` applied to its config first; and the
    config."""
    cfg = Config.fromfile(str(CONFIG))
    cfg.merge_from_dict(over)
    return make_model(SEED, cfg), cfg


def decoder_copy(decoder, **fields):
    """A shallow copy of ``decoder`` (its parameters shared) with
    ``fields`` set."""
    dec = copy.copy(decoder)
    for key, value in fields.items():
        setattr(dec, key, value)
    return dec


def stat_errors(card, cpu):
    """Per ``grad_*`` key |card - cpu| over the largest gradient RMS of
    its prefix (diffusion, decoder, code): phase 6's rule of 1e-3 of the
    largest entry, applied to the statistics."""
    top = {}
    for k, v in cpu.items():
        if k.startswith('grad_rms/'):
            p = k.split('/')[1].split('.')[0]
            top[p] = max(top.get(p, 0.0), abs(v))
    return {k: abs(card[k] - cpu[k]) / top[k.split('/')[1].split('.')[0]]
            for k in cpu if k.startswith('grad_')}


def render_rays(S, V, dev):
    """The rays of ``V`` orbit views of OPTIONS_RES^2 a scene: (S, V *
    OPTIONS_RES^2, 3) origins and directions."""
    poses, intr = orbit_cameras(S, V, dev)
    rays_o, rays_d = get_cam_rays(poses, intr, OPTIONS_RES, OPTIONS_RES)
    return rays_o.reshape(S, -1, 3), rays_d.reshape(S, -1, 3)


def render_grads(decoder, code, rays_o, rays_d, bitfield, grid_size):
    """A render of ``decoder`` (the codes ``code`` a leaf) and the
    gradients of a squared loss on its composited image w.r.t. the codes
    and the decoder's parameters: (image, [code grad, parameter
    grads])."""
    leaf = code.detach().requires_grad_()
    out = volume_render(decoder, leaf, rays_o, rays_d, bitfield, grid_size)
    img = out['image'] + 1 - out['weights_sum'][..., None]
    loss = ((img - 0.5) ** 2).mean()
    return out['image'].detach(), list(torch.autograd.grad(
        loss, [leaf] + list(decoder.parameters())))


def compare_render(tag, card, cpu, tol_grad=1e-3):
    """Phase 4's image limits (max 2e-2, mean 1e-3) and phase 6's gradient
    limit (1e-3 of the largest entry) on (image, grads) pairs."""
    (ci, cg), (pi, pg) = card, cpu
    err = (ci.cpu() - pi).abs()
    grad_err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp(
        min=1e-30)).item() for a, b in zip(cg, pg))
    log(f'phase 13 {tag} card vs cpu: image max {err.max().item():.2e} '
        f'mean {err.mean().item():.2e}; gradients {grad_err:.2e} of their '
        'largest entry')
    check(err.max().item() <= 2e-2 and err.mean().item() <= 1e-3,
          f'phase 13 {tag}: image card vs cpu')
    check(grad_err <= tol_grad, f'phase 13 {tag}: gradients card vs cpu')
    return dict(image_max=err.max().item(), image_mean=err.mean().item(),
                grads=grad_err)


def phase_options(dev, data, code, bitfield):
    """Phase 13: the options no shipped config sets, on
    configs/paper_cfgs/ssdnerf_cars_uncond.py at full width (3x6x128^2
    codes, 64^3 grid, phase 5's 8 scenes and phase 3's codes and
    bitfields, random seeded weights), each set by ``cfg-options``-style
    overrides and held card vs CPU at phase 6's limits (the CPU runs cut
    to 1 scene, as phase 6's; f32 decode there, where the plain versions
    are the reference):

    (a) ``DiffusionNeRF.train_step`` with ``density_partial_update``,
        ``log_grad_stats`` and ``scene_base_size`` (1, 3, 6, 128, 128):
        two steps of 8 scenes on the card (the second profiled), then card
        vs CPU: losses, the code moment, the UNet's and the decoder's
        gradients (the scene base's included), the bitfield's flipped
        share <= 1e-3 and every ``grad_*`` key;
    (b) a render of 8 x 4 x 128^2 rays with ``compact_steps=None``, forward
        and gradients (profiled), its image against the ``compact_steps``
        64 per-ray render (equal on rays of at most 64 valid samples), and
        card vs CPU on one view;
    (c) a decoder with ``base_layers`` (18, 64, 64) and ``dir_layers`` None
        (torch ops on the card: no decode kernel may launch): a render of
        8 x 128^2 rays and its gradients, and card vs CPU;
    (d) ``bg_coords`` with ``bg_radius`` 4 on (b)'s rays vs the CPU's;
    (e) two stage-1 iterations (stage1_cars_recons16v.py, its batch of 4
        scenes, bank cut to 16 rows) on the host bank and on the device
        bank: the same losses and bank rows;
    (f) ``MultiSceneNeRF.val_inverse_code`` with ``code_dropout`` 0.1
        (steps cut to 4) card vs CPU with the same draws and keep masks
        (phase 6's quantities: the loss, and the code Adam's first moment,
        the gradient, for the codes; the codes themselves are printed:
        Adam's first steps move a code by about its rate whatever the
        gradient's size, so a near-zero gradient summed in another order
        moves its code by a share of a step), and the raise of its
        ``train_step``.

    Prints each part's wall, device ms and kernel launches.  Returns the
    phase's launches (counts set to 0 just before it) and its record."""
    cuts, out, walls, device_ms, part_launches = [], {}, {}, {}, {}
    reset_launches()
    t_start = time.perf_counter()
    S = data['cond_imgs'].shape[0]
    view = OPTIONS_RES ** 2

    def part(tag, t0, before):
        walls[tag] = time.perf_counter() - t0
        now = launch_counts()
        part_launches[tag] = {n: now[n] - before[n] for n in now
                              if now[n] != before[n]}
        log(f'phase 13 ({tag}) wall {walls[tag]:.1f} s; launches '
            f'{part_launches[tag]}')

    # (a) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    ess = cut(cuts, 'train_cfg.extra_scene_step', 15, OPTIONS_ESS)
    interval = cut(cuts, 'model.update_extra_interval', 16, 1)
    code_size = tuple(Config.fromfile(str(CONFIG)).model.code_size)
    model_cpu, cfg = options_model({
        'model.decoder.scene_base_size': [1, *code_size],
        'model.update_extra_interval': interval,
        'train_cfg.extra_scene_step': ess,
        'train_cfg.density_partial_update': True,
        'train_cfg.log_grad_stats': True})
    model = copy.deepcopy(model_cpu).to(dev)
    H = model.grid_size
    slots, pack = model.test_cfg['march_slots'], model.test_cfg['pack_slots']
    base0 = model.decoder.scene_base.detach().clone()
    code_ = model.code_activation.inverse(code, model.code_act)
    batch = dict(code_=code_, opt=adam_init(code_),
                 density_grid=torch.zeros((S, H ** 3), dtype=torch.float16,
                                          device=dev),
                 density_bitfield=torch.zeros((S, H ** 3 // 8),
                                              dtype=torch.uint8, device=dev))
    opts, scheds = build_optimizers(model, cfg.optimizer, cfg.lr_config)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    partial_calls = []
    partial = ad_base.update_density_grid_partial
    logs = {}

    def step():
        nonlocal batch
        batch, res = model.train_step(batch, data, opts, scheds,
                                      generator=gen)
        logs.update(res)

    with mock_attr(ad_base, 'update_density_grid_partial',
                   lambda *a, **k: partial_calls.append(1) or partial(
                       *a, **k)):
        step()
        wall_ms, dev_ms, parts, groups, _ = profile_step(step)
    n_stats = 3 * (len(list(model.diffusion.parameters()))
                   + len(list(model.decoder.parameters())) + 1)
    stats = {k: v.item() for k, v in logs.items() if k.startswith('grad_')}
    moved = (model.decoder.scene_base - base0).abs().max().item()
    log(f'phase 13 (a) train step x{S} scenes: profiled wall {wall_ms:.1f} '
        f'ms, device {dev_ms:.1f} ms; by part: ' + ', '.join(
            f'{k} {v:.1f} ms' for k, v in parts.items()))
    log(f'phase 13 (a) losses: ' + ' '.join(
        f'{k}={logs[k].item():.5g}' for k in LOSS_KEYS)
        + f'; {len(stats)} grad_* keys; partial refreshes '
        f'{len(partial_calls)}; scene_base moved {moved:.3e}')
    for k in LOSS_KEYS:
        check(math.isfinite(logs[k].item()), f'phase 13 (a): {k}')
    check(len(stats) == n_stats and all(map(math.isfinite, stats.values())),
          'phase 13 (a): grad_* keys')
    for k in ('grad_rms/decoder.params.scene_base', 'grad_rms/code.',
              'grad_std/diffusion.params.out_conv.kernel'):
        check(k in stats, f'phase 13 (a): {k} missing')
    check(len(partial_calls) == 2, 'phase 13 (a): partial refreshes')
    check(moved > 0, 'phase 13 (a): scene_base did not move')
    device_ms['a_train_step'] = dev_ms
    # card vs CPU, 1 scene (phase 6's cut)
    tc = dict(model_cpu.train_cfg, n_inverse_rays=1024, n_decoder_rays=1024)
    cut(cuts, '(a) card vs cpu: scenes, rays', (S, 4096), (1, 1024))
    model_cpu.train_cfg = tc
    d1 = {k: v[:1].cpu() for k, v in data.items()}
    num_pixels = math.prod(d1['cond_imgs'].shape[1:4])
    draws = model_cpu.train_draws(1, num_pixels,
                                  torch.Generator().manual_seed(SEED + 51))
    draws['t'] = torch.tensor([model_cpu.diffusion.num_timesteps // 2])
    b1 = dict(code_=code_[:1].cpu(),
              density_grid=torch.zeros((1, H ** 3), dtype=torch.float16),
              density_bitfield=torch.zeros((1, H ** 3 // 8),
                                           dtype=torch.uint8))
    runs = {}
    for tag, d in (('card', dev), ('cpu', 'cpu')):
        m = copy.deepcopy(model_cpu).to(d)
        o, s = build_optimizers(m, cfg.optimizer, cfg.lr_config)
        bd = to_device(b1, d)
        bd['opt'] = adam_init(bd['code_'])
        with decode_dtype(m, 'float32'):
            res, lg = m.train_step(bd, to_device(d1, d), o, s,
                                   draws=to_device(draws, d))
        runs[tag] = dict(logs={k: v.item() for k, v in lg.items()},
                         code_m=res['opt'].m.cpu(),
                         bits=res['density_bitfield'].cpu(),
                         unet=module_grads(m.diffusion).cpu(),
                         decoder=module_grads(m.decoder).cpu(),
                         scene_base=m.decoder.scene_base.grad.cpu())
        del m
    card, cpu = runs['card'], runs['cpu']
    errs = {k: abs(card['logs'][k] - cpu['logs'][k]) / abs(cpu['logs'][k])
            for k in LOSS_KEYS}
    errs.update({k: ((card[k] - cpu[k]).abs().max()
                     / cpu[k].abs().max()).item()
                 for k in ('code_m', 'unet', 'decoder', 'scene_base')})
    flips = (np.unpackbits(card['bits'].numpy())
             != np.unpackbits(cpu['bits'].numpy())).mean()
    serr = stat_errors(card['logs'], cpu['logs'])
    worst = max(serr, key=serr.get)
    log(f'phase 13 (a) card vs cpu (f32 decode): ' + ' '.join(
        f'{k} {v:.2e}' for k, v in errs.items())
        + f'; bits flipped {flips:.2e}; grad_* keys equal '
        f'{set(card["logs"]) == set(cpu["logs"])}, worst {worst} '
        f'{serr[worst]:.2e}')
    for k, v in errs.items():
        check(v <= (1e-4 if k in LOSS_KEYS else 1e-3),
              f'phase 13 (a) card vs cpu: {k}')
    check(flips <= 1e-3, 'phase 13 (a) card vs cpu: bitfield')
    check(set(card['logs']) == set(cpu['logs']),
          'phase 13 (a): grad_* keys card vs cpu')
    check(serr[worst] <= 1e-3, 'phase 13 (a) card vs cpu: grad_* values')
    out['a'] = dict(device_ms=dev_ms, wall_ms=wall_ms, card_vs_cpu=errs,
                    bits_flipped=flips, grad_stats_worst=serr[worst],
                    grad_keys=len(stats))
    del opts, batch
    part('a', t0, before)

    # (b) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    rays_o, rays_d = render_rays(S, 4, dev)
    dense = decoder_copy(model.decoder, compact_steps=None,
                         march_slots=slots, pack_slots=pack)
    res = {}

    def run_dense():
        res['img'], res['grads'] = render_grads(dense, code, rays_o, rays_d,
                                                bitfield, H)

    wall_ms, dev_ms, parts, _, _ = profile_step(run_dense, ranges=())
    check(all(torch.isfinite(g).all().item() for g in res['grads'])
          and torch.isfinite(res['img']).all().item(),
          'phase 13 (b): not finite')
    per_ray = decoder_copy(model.decoder, compact_steps=64,
                           march_slots=slots, pack_slots=None)
    with torch.no_grad():
        img64 = volume_render(per_ray, code, rays_o, rays_d, bitfield,
                              H)['image']
        _, _, _, valid = dec_renderer.march_samples(
            dense, rays_o, rays_d, bitfield, H)
    n_valid = valid.sum(-1)
    diff = (res['img'] - img64).abs().amax(-1)
    few, many = diff[n_valid <= 64], diff[n_valid > 64]
    log(f'phase 13 (b) dense render {S}x4x{OPTIONS_RES}^2 ({slots} march '
        'slots): '
        f'profiled wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms; vs the '
        f'compact_steps 64 per-ray render: max |image diff| '
        f'{few.max().item():.2e} on {few.numel()} rays of <= 64 valid '
        f'samples, {many.max().item() if many.numel() else 0.0:.2e} (mean '
        f'{many.mean().item() if many.numel() else 0.0:.2e}) on '
        f'{many.numel()} rays of more')
    check(few.max().item() <= 1e-5, 'phase 13 (b): dense vs 64 on rays of '
          '<= 64 valid samples')
    device_ms['b_dense_render'] = dev_ms
    cut(cuts, '(b) card vs cpu: scenes x views', (S, 4), (1, 1))
    o1, d1r = rays_o[:1, :view].cpu(), rays_d[:1, :view].cpu()
    pair = {}
    dec = decoder_copy(model_cpu.decoder, compact_steps=None,
                       march_slots=slots, pack_slots=pack,
                       compute_dtype='float32')
    for tag, d in (('card', dev), ('cpu', 'cpu')):
        pair[tag] = render_grads(copy.deepcopy(dec).to(d), code[:1].to(d),
                                 o1.to(d), d1r.to(d), bitfield[:1].to(d), H)
    out['b'] = dict(device_ms=dev_ms, wall_ms=wall_ms,
                    vs_k64_few=few.max().item(),
                    vs_k64_many=many.max().item() if many.numel() else 0.0,
                    rays_over_64=many.numel(),
                    card_vs_cpu=compare_render('(b)', pair['card'],
                                               pair['cpu']))
    del res, dense
    part('b', t0, before)

    # (c) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    width = cfg.model.decoder.base_layers[-1]
    fields = dict(cfg.model.decoder, base_layers=[3 * code_size[1], width,
                                                  width],
                  dir_layers=None, color_layers=[width + 16, 3])
    fields.pop('scene_base_size', None)
    free = ad_ms.build_decoder(fields)
    free.init_weights(torch.Generator().manual_seed(SEED + 52))
    check(not free.kernel_route, 'phase 13 (c): kernel route')
    free_dev = copy.deepcopy(free).to(dev)
    ro8, rd8 = rays_o[:, :view], rays_d[:, :view]
    res = {}

    def run_free():
        res['img'], res['grads'] = render_grads(free_dev, code, ro8, rd8,
                                                bitfield, H)

    wall_ms, dev_ms, _, groups, _ = profile_step(run_free, ranges=())
    now = launch_counts()
    decodes = sum(now[n] - before[n] for n in now if n.startswith('decode'))
    log(f'phase 13 (c) free-form decoder render {S}x{OPTIONS_RES}^2: '
        f'base_layers {fields["base_layers"]}, dir_layers None; profiled wall '
        f'{wall_ms:.1f} ms, device {dev_ms:.1f} ms; decode kernel launches '
        f'{decodes}')
    check(decodes == 0, 'phase 13 (c): a decode kernel launched')
    check(torch.isfinite(res['img']).all().item(), 'phase 13 (c): image')
    device_ms['c_free_form_render'] = dev_ms
    cut(cuts, '(c) card vs cpu: scenes', S, 1)
    pair = {}
    for tag, d, dec in (('card', dev, free_dev), ('cpu', 'cpu', free)):
        dec32 = decoder_copy(dec, compute_dtype='float32')
        pair[tag] = render_grads(dec32, code[:1].to(d), o1.to(d), d1r.to(d),
                                 bitfield[:1].to(d), H)
    out['c'] = dict(device_ms=dev_ms, wall_ms=wall_ms,
                    card_vs_cpu=compare_render('(c)', pair['card'],
                                               pair['cpu']))
    del res, free_dev
    part('c', t0, before)

    # (d) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    bg = decoder_copy(model.decoder, bg_radius=4.0)
    with torch.no_grad():
        got = volume_render(bg, code, rays_o, rays_d, bitfield, H)
        plain = volume_render(model.decoder, code, rays_o, rays_d, bitfield,
                              H)
    ref = sph_from_ray(rays_o.cpu(), rays_d.cpu(), 4.0)
    err = (got['bg_coords'].cpu() - ref).abs().max().item()
    log(f'phase 13 (d) bg_coords {tuple(got["bg_coords"].shape)}: card vs '
        f'cpu max {err:.2e}; image unchanged '
        f'{torch.equal(got["image"], plain["image"])}')
    check(got['bg_coords'].shape == (S, rays_o.shape[1], 2) and err <= 1e-5,
          'phase 13 (d): bg_coords')
    check(torch.equal(got['image'], plain['image']), 'phase 13 (d): image')
    out['d'] = dict(card_vs_cpu=err)
    del model, model_cpu, got, plain
    torch.cuda.empty_cache()
    part('d', t0, before)

    # (e) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    s1 = init_model(str(STAGE1), 'cpu', SEED).train()
    rows = cut(cuts, '(e) bank rows', 2458, 16)
    s1.cache_size = rows
    n = cut(cuts, '(e) scenes', S, min(S, 4))   # the config's batch
    ids = list(range(n))
    d4 = {k: v[:n] for k, v in data.items()}
    draws = [s1.train_draws(n, math.prod(d4['cond_imgs'].shape[1:4]),
                            torch.Generator(device=dev).manual_seed(
                                SEED + 53 + it), dev) for it in range(2)]
    runs = {}
    for where in ('device', 'host'):
        m = copy.deepcopy(s1).to(dev)
        m.cache_device = where
        bank = m.make_cache(dev)
        o, s = build_optimizers(m, dict(decoder=dict(type='Adam', lr=1e-3)))
        losses = []
        for it in range(2):
            rng = np.random.RandomState(0)
            bank.ensure_init(ids, lambda k: m.get_init_code_np(
                k, rng, m.init_code_np()))
            res, lg = m.train_step(bank.load(ids), d4, o, s, draws=draws[it])
            bank.save(ids, res['code_'], res['opt'], res['density_grid'],
                      res['density_bitfield'])
            losses.append(lg['loss'].item())
        runs[where] = (type(bank).__name__, losses, bank.state_dict())
        del m, bank
    (dn, dl, dsd), (hn, hl, hsd) = runs['device'], runs['host']
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(hl, dl))
    code_err = (np.abs(hsd['code_'] - dsd['code_']).max()
                / np.abs(dsd['code_']).max())
    flips = (np.unpackbits(hsd['density_bitfield'])
             != np.unpackbits(dsd['density_bitfield'])).mean()
    equal = all(np.array_equal(hsd[k], dsd[k]) for k in dsd)
    log(f'phase 13 (e) stage-1 x2 iterations, {n} scenes, {dn} vs {hn}: '
        f'losses {dl} / {hl} (rel {loss_err:.2e}); bank rows bit-equal '
        f'{equal}; codes {code_err:.2e} of the largest, bits flipped '
        f'{flips:.2e}; Adam steps {hsd["step"][:n].tolist()}')
    check(hn == 'HostSceneCache' and dn == 'DeviceSceneCache',
          'phase 13 (e): bank types')
    check(loss_err <= 1e-4 and code_err <= 1e-3 and flips <= 1e-3,
          'phase 13 (e): host vs device bank')
    check(np.array_equal(hsd['step'], dsd['step'])
          and np.array_equal(hsd['seen'], dsd['seen']),
          'phase 13 (e): Adam steps, seen')
    out['e'] = dict(losses_rel=loss_err, codes=float(code_err),
                    bits_flipped=flips, bit_equal=equal)
    part('e', t0, before)

    # (f) ------------------------------------------------------------
    t0, before = time.perf_counter(), launch_counts()
    steps = cut(cuts, '(f) test_cfg.n_inverse_steps', 400,
                OPTIONS_INVERSE_STEPS)
    cfg_f = Config.fromfile(str(STAGE1))
    cfg_f.merge_from_dict({'model.decoder.code_dropout': 0.1,
                           'test_cfg.n_inverse_steps': steps})
    drop = init_model(cfg_f, 'cpu', SEED)
    d1 = {k: v[:1].cpu() for k, v in data.items()}
    draws = drop.val_inverse_draws(1, math.prod(d1['cond_imgs'].shape[1:4]),
                                   torch.Generator().manual_seed(SEED + 54))
    share = 1 - draws['dropout'].float().mean().item()
    runs = {}
    made = ad_ms.inverse_code
    for tag, d in (('card', dev), ('cpu', 'cpu')):
        m = copy.deepcopy(drop).to(d)
        kept = []      # the code Adam's state, which val_inverse_code drops

        def keep(*args, **kwargs):
            res = made(*args, **kwargs)
            kept.append(res[1])
            return res

        with decode_dtype(m, 'float32'), mock_attr(ad_ms, 'inverse_code',
                                                   keep):
            c, g, b, aux = m.val_inverse_code(to_device(d1, d),
                                              to_device(draws, d))
        runs[tag] = (c.cpu(), b.cpu(), aux['loss'].item(), kept[0].m.cpu())
    (cc, cb, cl, cm), (pc, pb, pl, pm) = runs['card'], runs['cpu']
    code_err = ((cc - pc).abs().max() / pc.abs().max()).item()
    m_err = ((cm - pm).abs().max() / pm.abs().max()).item()
    flips = (np.unpackbits(cb.numpy()) != np.unpackbits(pb.numpy())).mean()
    loss_err = abs(cl - pl) / abs(pl)
    m = copy.deepcopy(drop).to(dev)
    o, s = build_optimizers(m, dict(decoder=dict(type='Adam', lr=1e-3)))
    b1 = dict(code_=torch.zeros((1,) + m.code_size, device=dev),
              density_grid=torch.zeros((1, H ** 3), dtype=torch.float16,
                                       device=dev),
              density_bitfield=torch.zeros((1, H ** 3 // 8),
                                           dtype=torch.uint8, device=dev))
    b1['opt'] = adam_init(b1['code_'])
    try:
        m.train_step(b1, to_device(d1, dev), o, s,
                     generator=torch.Generator(device=dev).manual_seed(0))
        raised = None
    except RuntimeError as e:
        raised = str(e)
    log(f'phase 13 (f) val_inverse_code, code_dropout 0.1 ({share:.3f} of '
        f'the channels dropped), {steps} steps: card vs cpu code Adam '
        f'moment {m_err:.2e} of the largest (codes {code_err:.2e}), loss '
        f'rel {loss_err:.2e}, bits '
        f'flipped {flips:.2e}; train_step raised: {raised}')
    check(0.0 < share < 0.3, 'phase 13 (f): dropout share')
    check(m_err <= 1e-3 and loss_err <= 1e-4 and flips <= 1e-3,
          'phase 13 (f): val_inverse_code card vs cpu')
    check(raised is not None and 'item 20' in raised,
          'phase 13 (f): train_step with code_dropout did not raise')
    out['f'] = dict(code_m=m_err, codes=code_err, loss_rel=loss_err,
                    bits_flipped=flips)
    del m, drop
    part('f', t0, before)

    launches = launch_counts()
    wall = time.perf_counter() - t_start
    log(f'phase 13 cuts: ' + '; '.join(cuts))
    log(f'phase 13 device ms: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in device_ms.items())
        + f'; walls: ' + ', '.join(f'({k}) {v:.1f} s'
                                   for k, v in walls.items())
        + f'; decode launches ' + str({n: launches[n] for n in launches
                                       if n.startswith('decode')}))
    for name in OPTIONS_KERNELS:
        check(launches[name] > 0,
              f'phase 13: kernel {name} was not launched')
    out.update(cuts=cuts, walls_s=walls, device_ms=device_ms,
               part_launches=part_launches, wall_s=wall)
    return launches, out


VIEWER_DRAG = 4             # the drag preview's 1/4 size (128^2 of 512^2)
VIEWER_FRAMES = 8           # (a)'s orbit frames (the CLI's default 60)
VIEWER_MESH_RES = 64        # (a)'s mesh grid (the viewer's default 256)
VIEWER_CLI_FRAMES = 2       # (b)'s orbit frames through the CLI
INTERP_SAMPLES = 10         # (b)'s interpolation stops: the demo's 10, one
                            # batch of its default 10, where the f32 UNet
                            # takes cuDNN's FFT convolutions ((a)'s UNet
                            # line); so its DDIM steps are cut instead
INTERP_DDIM_STEPS = 2       # (b)'s DDIM steps (the config's 50)
VALIDATE_3D_ITERS = 6       # (c)'s iterations (the tool's 301)
VALIDATE_DIFF_ITERS = 4     # (c)'s iterations (the tool's 800)
VALIDATE_DIFF_STEPS = 2     # (c)'s DDIM steps of the 4 samples (20)
SPIRAL = ROOT / 'demo' / 'camera_spiral'
VIEWER_KERNELS = ('march', 'decode_bf16', 'attention', 'attention_bf16')
# the sampling UNet's batches: the viewer's 1, the validators' 4 (like
# the demo's default 10), phase 3's 8; profiled at 1 and 8 only (batch 4's
# forward launches ~330,000 kernels, whose profile alone takes seconds)
UNET_BATCHES = (1, 4, 8)
UNET_PROFILED = (1, 8)


def timed(fn):
    """(fn(), wall seconds to a device synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def unet_batches(model, dev):
    """One f32 forward of the sampling (EMA) UNet without autograd, as the
    samplers call it, at each batch of UNET_BATCHES: the median of 3 walls
    to a device synchronise after a warm-up, and at the batches of
    UNET_PROFILED one profiled call's device ms by kernel group and its
    longest kernel."""
    unet = model.ema_diffusion.denoising
    out = {}
    for n in UNET_BATCHES:
        x = torch.randn((n,) + model.code_diff_size, device=dev)
        t = torch.full((n,), 500, device=dev)
        with torch.no_grad():
            run = lambda: unet(x, t)  # noqa: E731
            run()
            walls = [timed(run)[1] for _ in range(3)]
            out[n] = dict(median_ms=statistics.median(walls) * 1e3)
            line = (f'phase 14 (a) UNet forward, batch {n}: median '
                    f'{out[n]["median_ms"]:.2f} ms')
            if n in UNET_PROFILED:
                _, dev_ms, _, groups, top = profile_step(run, ranges=())
                name, (calls, ms) = top[0] if top else ('none', (0, 0.0))
                out[n].update(device_ms=dev_ms, groups=groups, longest=dict(
                    name=name, calls=calls, ms=ms))
                line += (f', {dev_ms:.2f} device ms (' + ', '.join(
                    f'{k} {v:.2f}' for k, v in sorted(
                        groups.items(), key=lambda kv: -kv[1])[:3])
                    + f'); longest kernel {name[:90]} x{calls} {ms:.2f} ms')
        log(line)
    return out


def phase_viewer(model_cpu, dev, root):
    """Phase 14 (a): the viewer (``core/gui.py``) at flagship width on the
    seeded flagship model, as the interactive viewer serves it: the camera
    from ``demo/camera_spiral`` (pose 64), ``generate(seed=0)`` (batch 1,
    the config's 50 DDIM steps, the 8-sweep density rebuild) in f32 and
    under ``--fp16`` (bf16 autocast), three renders each of the 512^2
    view and of the 128^2 drag preview (median wall, one profiled), 8
    orbit frames; then, outside the launch counts, the sampling UNet's
    forward at the batches of UNET_BATCHES, a scene file's save / load
    round trip (bitwise) and ``tools/convert_cache`` both ways on it
    (bitwise), a mesh, and one 128^2 view on the card against the CPU (the
    bf16 decode and the f32 one, phase 4's limits).  The launches of the
    path from the generation to the orbit frames (counts set to 0 just
    before, read just after) must include the march, the bf16 decode and
    both attention forwards.  Returns (those launches, the record)."""
    out = {}
    log(f'phase 14 (a) cuts: orbit frames 60 -> {VIEWER_FRAMES}, mesh '
        f'256^3 -> {VIEWER_MESH_RES}^3 (the host\'s marching tetrahedra, '
        'phase 9: 4.3 s at 128^3)')
    model = copy.deepcopy(model_cpu).to(dev)
    viewer = SSDNeRFViewer(model)
    viewer.load_camera_dir(str(SPIRAL), camera_id=64)
    S = viewer.cam.H
    reset_launches()
    _, out['generate_s'] = timed(lambda: viewer.generate(seed=0))
    code, grid, bitfield = (viewer.code, viewer.density_grid,
                            viewer.density_bitfield)
    model.autocast_dtype = 'bfloat16'
    try:
        fp16_code, out['generate_fp16_s'] = timed(
            lambda: viewer.generate(seed=0).clone())
    finally:
        model.autocast_dtype = None
    occ = np.unpackbits(bitfield.cpu().numpy()).mean()
    out['fp16_code_rel_l2'] = l2(fp16_code, code)
    log(f'phase 14 (a) generate(seed=0), 1 scene, '
        f'{model.test_cfg["num_timesteps"]} DDIM steps: f32 '
        f'{out["generate_s"]:.3f} s, fp16 {out["generate_fp16_s"]:.3f} s '
        f'(codes rel l2 {out["fp16_code_rel_l2"]:.3e} from f32); occupancy '
        f'{occ:.4f}')
    check(code.shape == (1,) + model.code_size
          and torch.isfinite(code).all().item()
          and torch.isfinite(fp16_code).all().item(), 'viewer codes')
    check(0.0 < occ < 1.0, 'viewer density grid empty or full')
    viewer.set_scene(code, grid, bitfield)
    for ds in (1, VIEWER_DRAG):
        side = S // ds
        walls = []
        for _ in range(3):
            img, dt = timed(lambda: viewer.render_view(downscale=ds))
            walls.append(dt)
        wall_ms, dev_ms, _, groups, _ = profile_step(
            lambda: viewer.render_view(downscale=ds), ranges=(),
            group_of=render_group)
        bg = float((np.abs(img - 1).max(-1) < 1e-3).mean())
        out[f'render_{side}'] = dict(
            median_s=statistics.median(walls), walls_s=walls,
            profiled_wall_ms=wall_ms, device_ms=dev_ms, groups=groups,
            background_share=bg)
        log(f'phase 14 (a) render_view {side}^2 ({side * side} rays): '
            f'median {statistics.median(walls) * 1e3:.2f} ms of '
            f'{[round(w * 1e3, 2) for w in walls]}; profiled '
            f'{wall_ms:.2f} ms wall, {dev_ms:.3f} device ms: ' + ', '.join(
                f'{k} {v:.3f}' for k, v in sorted(
                    groups.items(), key=lambda kv: -kv[1])[:6])
            + f'; background share {bg:.3f}')
        check(img.shape == (side, side, 3) and np.isfinite(img).all(),
              f'viewer image {side}^2')
    frames, out['orbit_s'] = timed(
        lambda: viewer.render_orbit_frames(num_frames=VIEWER_FRAMES))
    launches = launch_counts()
    log(f'phase 14 (a) {VIEWER_FRAMES} orbit frames of {S}^2 in '
        f'{out["orbit_s"]:.3f} s; launches {launches}')
    check(len(frames) == VIEWER_FRAMES and all(
        f.shape == (S, S, 3) and f.dtype == np.uint8 for f in frames)
        and not np.array_equal(frames[0], frames[VIEWER_FRAMES // 2]),
        'orbit frames')
    for name in VIEWER_KERNELS:
        check(launches[name] > 0,
              f'kernel {name} was not launched by the viewer')
    out['unet_forward'] = unet_batches(model, dev)

    # scene file round trip, then the cache converter both ways
    scene = root / 'scene.npz'
    viewer.save_scene_file(str(scene))
    other = SSDNeRFViewer(model)
    other.load_scene_file(str(scene))
    same = all(torch.equal(getattr(other, k), getattr(viewer, k)) for k in (
        'code', 'density_grid', 'density_bitfield'))
    cache, pth, back = (root / d for d in ('cache', 'pth', 'back'))
    cache.mkdir()
    raw = dict(code_=model.code_activation.inverse(code, model.code_act)[0],
               density_grid=grid[0], density_bitfield=bitfield[0])
    raw = {k: v.cpu().numpy() for k, v in raw.items()}
    np.savez(cache / 'scene.npz', **raw)
    t0 = time.perf_counter()
    convert_cache.main([str(cache), str(pth), '--to', 'pth'])
    convert_cache.main([str(pth), str(back)])
    out['convert_cache_s'] = time.perf_counter() - t0
    with np.load(back / 'scene.npz') as d:
        cache_same = all(np.array_equal(d[k], v) and d[k].dtype == v.dtype
                         for k, v in raw.items())
    log(f'phase 14 (a) scene file {scene.stat().st_size / 2 ** 20:.1f} MiB '
        f'round trip bitwise {same}; convert_cache npz -> pth (Morton) -> '
        f'npz in {out["convert_cache_s"]:.2f} s, bitwise {cache_same}')
    check(same and cache_same, 'scene file / convert_cache round trip')

    # a mesh; random weights leave no surface at the default threshold
    # (10), so the threshold is the occupied grid's 99th percentile
    g = grid.float().cpu().numpy()
    thresh = float(np.quantile(g[g > 0], 0.99))
    stl = root / 'scene.stl'
    _, out['mesh_s'] = timed(lambda: viewer.export_mesh(
        str(stl), resolution=VIEWER_MESH_RES, threshold=thresh))
    tris = int.from_bytes(stl.read_bytes()[80:84], 'little')
    out['mesh_triangles'] = tris
    log(f'phase 14 (a) mesh at {VIEWER_MESH_RES}^3 (threshold {thresh:.4g})'
        f': {tris} triangles in {out["mesh_s"]:.2f} s')
    check(tris > 0 and stl.stat().st_size == 84 + 50 * tris, 'viewer mesh')

    # one drag-preview view of the same scene on the card and the CPU
    cpu = SSDNeRFViewer(model_cpu)
    cpu.cam = copy.deepcopy(viewer.cam)
    cpu.set_scene(code.cpu(), grid.cpu(), bitfield.cpu())
    img = {}
    for dt in ('float32', 'bfloat16'):
        with decode_dtype(model, dt), decode_dtype(model_cpu, dt):
            for tag, v in (('card', viewer), ('cpu', cpu)):
                img[dt, tag] = torch.from_numpy(v.render_view(
                    downscale=VIEWER_DRAG))
    out['card_vs_cpu'] = {dt: (img[dt, 'card'] - img[dt, 'cpu']).abs().max(
        ).item() for dt in ('float32', 'bfloat16')}
    check(image_card_vs_cpu(f'phase 14 (a) {S // VIEWER_DRAG}^2 view', img),
          'viewer view card vs cpu')
    return launches, out


def phase_viewer_cli(model_cpu, dev, root):
    """Phase 14 (b): the headless viewer CLI and the interpolation demo in
    this process on a checkpoint of the seeded flagship model (TF32 as a
    fresh process has it): ``ssdnerf_torch.demo.ssdnerf_gui.main`` (the
    camera from ``demo/camera_spiral``, ``generate``, orbit frames as PNGs)
    and ``ssdnerf_torch.demo.interp_diffusion_nerf_ddim.main`` (spherical
    interpolation at its default batch of 10, 2 poses of 128^2, on the
    config with its DDIM steps cut); each one's wall, launches and PNGs
    checked."""
    out, cuts = {}, []
    cfg = Config.fromfile(str(CONFIG))
    cfg.test_cfg.num_timesteps = cut(cuts, 'interpolation DDIM steps',
                                     cfg.test_cfg.num_timesteps,
                                     INTERP_DDIM_STEPS)
    interp_cfg = root / 'interp_cfg.py'
    interp_cfg.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    log(f'phase 14 (b) cuts: CLI orbit frames 60 -> {VIEWER_CLI_FRAMES}, '
        + '; '.join(cuts))
    ckpt = str(root / 'flagship_seed0.ckpt')
    _, out['checkpoint_s'] = timed(lambda: save_checkpoint(ckpt, model_cpu))
    frames, interp = root / 'frames', root / 'interp'
    with fresh_process_tf32():
        reset_launches()
        viewer, out['cli_s'] = timed(lambda: ssdnerf_gui.main([
            str(CONFIG), ckpt, '--device', str(dev), '--cameras',
            str(SPIRAL), '--out-frames',
            str(frames), '--num-frames', str(VIEWER_CLI_FRAMES)]))
        out['cli_launches'] = launch_counts()
        del viewer
        reset_launches()
        paths, out['interp_s'] = timed(lambda: interp_demo.main([
            str(interp_cfg), ckpt, '--device', str(dev), '--viz-dir',
            str(interp), '--cameras', str(SPIRAL), '--pose-ids', '0', '64',
            '--num-samples', str(INTERP_SAMPLES)]))
        out['interp_launches'] = launch_counts()
    pngs = [read_png(str(f)) for f in sorted(frames.iterdir())]
    views = [read_png(p) for p in paths]
    log(f'phase 14 (b) checkpoint of the seeded flagship model written in '
        f'{out["checkpoint_s"]:.2f} s; python -m '
        f'ssdnerf_torch.demo.ssdnerf_gui {CONFIG.name} <ckpt> '
        f'--cameras demo/camera_spiral --out-frames D --num-frames '
        f'{VIEWER_CLI_FRAMES}: {out["cli_s"]:.2f} s, {len(pngs)} PNGs, '
        f'launches {out["cli_launches"]}; interpolation demo '
        f'{INTERP_SAMPLES} stops (one batch) x 2 poses: '
        f'{out["interp_s"]:.2f} s, {len(views)} PNGs, launches '
        f'{out["interp_launches"]}')
    check(len(pngs) == VIEWER_CLI_FRAMES and all(
        p.shape == (512, 512, 3) for p in pngs), 'CLI frames')
    check(len(views) == 2 * INTERP_SAMPLES and all(
        v.shape == (128, 128, 3) for v in views), 'interpolation PNGs')
    for tag in ('cli', 'interp'):
        for name in SERVING:
            check(out[f'{tag}_launches'][name] > 0,
                  f'kernel {name} was not launched by the {tag} run')
    return out


def phase_validators(dev):
    """Phase 14 (c): the learning validators at a cut depth (printed, not
    asserted): ``validate_3d_learning`` (stage 1 on 4 sphere scenes) and
    ``validate_diffusion_learning`` (single stage on 8, then 4 samples)."""
    log(f'phase 14 (c) cuts: validate_3d_learning 301 -> '
        f'{VALIDATE_3D_ITERS} iterations, validate_diffusion_learning 800 '
        f'-> {VALIDATE_DIFF_ITERS}, its samples\' DDIM steps 20 -> '
        f'{VALIDATE_DIFF_STEPS}')
    out = {}
    t0 = time.perf_counter()
    out['3d'] = validate_3d_learning.main(
        VALIDATE_3D_ITERS, dev, log=lambda *m: log('phase 14 (c) 3d:', *m))
    out['3d']['total_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['diffusion'] = validate_diffusion_learning.main(
        VALIDATE_DIFF_ITERS, dev,
        log=lambda *m: log('phase 14 (c) diffusion:', *m),
        sample_steps=VALIDATE_DIFF_STEPS)
    out['diffusion']['total_s'] = time.perf_counter() - t0
    values = [out['3d']['train_psnr'], *out['3d']['heldout_psnr'],
              out['diffusion']['train_code_rms'],
              out['diffusion']['sample_code_rms']]
    check(all(math.isfinite(v) for v in values), 'validators not finite')
    log(f'phase 14 (c) walls: 3d {out["3d"]["total_s"]:.2f} s, diffusion '
        f'{out["diffusion"]["total_s"]:.2f} s')
    return out


def main():
    walls = {}

    def done(phase):
        """Prints the wall seconds since the last phase ended."""
        walls[phase] = time.perf_counter() - T0 - sum(walls.values())
        log(f'phase {phase} wall: {walls[phase]:.1f} s '
            f'({time.perf_counter() - T0:.1f} s since the start)')

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
    done('1 (with the build)')

    kernels, lib_kernels = phase_kernels(dev)
    probe_launches, probe = phase_probe(dev)
    done(2)
    cfg = Config.fromfile(str(CONFIG))
    model_cpu = make_model(SEED)
    model_dev = copy.deepcopy(model_cpu).to(dev)
    serve_launches, code, bitfield, times = phase_slice(model_dev, dev)
    variant_launches, variants = phase_variants(model_dev, code, bitfield,
                                                dev)
    done(3)
    f32_render_launches = phase_card_vs_cpu(model_cpu, model_dev, dev)
    f32_variant_launches = phase_variants_card_vs_cpu(model_cpu, model_dev,
                                                      code, dev)
    f32_render_launches.update({n: f32_variant_launches[n] for n in
                                ('decode_composite', 'decode_banded')})
    for name in F32_RENDER:
        check(f32_render_launches[name] > 0,
              f'kernel {name} was not launched by the f32 renders')
    done(4)
    data = training_data(model_dev, code, bitfield, dev)
    train_launches, train_times = phase_train(model_dev, cfg, data, code,
                                               dev)
    done(5)
    del model_dev
    torch.cuda.empty_cache()
    f32_train_launches = phase_train_card_vs_cpu(model_cpu, cfg, data, code,
                                                 dev)
    for name in F32_TRAIN:
        check(f32_train_launches[name] > 0,
              f'kernel {name} was not launched by the f32 train step')
    done(6)

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
    del model_bf16_dev, model_bf16_cpu
    torch.cuda.empty_cache()
    done(7)

    # reconstruction: the recons1v configuration, the same seeded weights
    model_recons_cpu = make_model(SEED, CONFIG_RECONS)
    model_recons_dev = copy.deepcopy(model_recons_cpu).to(dev)
    recons_launches, recons_fp16_launches, recons = phase_recons(
        model_recons_dev, data, dev)
    recons['card_vs_cpu'] = phase_recons_card_vs_cpu(
        model_recons_cpu, model_recons_dev, data, dev)
    done(8)

    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        root = Path(tmp)
        # evaluation: the CLI on both configurations, the same seeded
        # weights
        evals = phase_eval(model_recons_dev, model_recons_cpu, code,
                           bitfield, dev, root)
        done(9)
        # training through the CLI on the card, then the runner on the
        # card and the CPU; the recons1v decoder is the flagship's
        write_train_set(model_recons_dev, code, bitfield, root)
        del model_recons_dev
        torch.cuda.empty_cache()
        train_cli_out = phase_train_cli(dev, root, evals['max_render_rays'])
        torch.cuda.empty_cache()
        train_cli_out['card_vs_cpu'] = phase_runner_card_vs_cpu(
            model_cpu, cfg, root, dev)
        done(10)
        # stage-1 and two-stage training through the CLI on phase 10's
        # cars_train, then the stage-1 step on the card and the CPU
        torch.cuda.empty_cache()
        stage1_out = phase_stage1_cli(dev, root, smi)
        torch.cuda.empty_cache()
        stage1_launches, stage1_out['card_vs_cpu'] = \
            phase_stage1_card_vs_cpu(root, dev)
        for name in STAGE1_KERNELS:
            check(stage1_launches[name.replace('_bf16', '')] > 0,
                  f'phase 11 (e): kernel {name} (f32) was not launched')
        done(11)
        # the tiled config at every width, its CLI on phase 10's cars_train
        torch.cuda.empty_cache()
        tiled_train_launches, tiled_launches, tiled_out = phase_tiled(
            dev, root, data, code, smi, evals['max_render_rays'])
        done(12)
    # the options no shipped config sets, at the flagship's width
    torch.cuda.empty_cache()
    options_launches, options_out = phase_options(dev, data, code, bitfield)
    done(13)
    # the viewer, its CLI and the demo, the learning validators
    del data
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        viewer_launches, viewer_out = phase_viewer(model_cpu, dev, Path(tmp))
        torch.cuda.empty_cache()
        viewer_out['cli'] = phase_viewer_cli(model_cpu, dev, Path(tmp))
    torch.cuda.empty_cache()
    viewer_out['validators'] = phase_validators(dev)
    done(14)

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
            'library_ms', 'device_ms', 'library_device_ms', 'rows')
    # the reconstruction's counts: the f32-UNet reconstruction's, the bf16
    # attention's from the use_fp16 guide
    recons['launches'] = {n: recons_fp16_launches[n] if n in RECONS_FP16
                          else recons_launches[n] for n in WRAPPERS}
    report = [dict(name=name, route='cuda', source=KERNEL_META[name][0],
                   replaces=KERNEL_META[name][1], launches=launches[name],
                   recons_launches=recons['launches'][name],
                   eval_uncond_launches=evals['runs']['uncond']['launches'][
                       name],
                   eval_recons_launches=evals['runs']['recons']['launches'][
                       name],
                   train_cli_launches=train_cli_out['runs']['a']['launches'][
                       name],
                   stage1_cli_launches=stage1_out['runs']['a']['launches'][
                       name],
                   stage2_cli_launches=stage1_out['runs']['d']['launches'][
                       name],
                   tiled_train_launches=tiled_train_launches[name],
                   tiled_recons_launches=tiled_launches[name],
                   options_launches=options_launches[name],
                   viewer_launches=viewer_launches[name],
                   **{k: kernels[name][k] for k in keys})
              for name in WRAPPERS]
    log(json.dumps({'kernels': report, 'slice_seconds': times,
                    'profiler_retakes': device_profile.retries,
                    'variants': variants, 'train': train_times,
                    'probe': probe, 'library_kernels': lib_kernels,
                    'bf16': dict(generation=bf16_gen, card_vs_cpu=bf16_vs_cpu,
                                 train=bf16_train,
                                 unet_forward_device_ms=precision_ms),
                    'recons': recons, 'eval': evals,
                    'train_cli': train_cli_out, 'stage1': stage1_out,
                    'tiled': tiled_out, 'options': options_out,
                    'viewer': viewer_out,
                    'phase_walls_s': walls}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
