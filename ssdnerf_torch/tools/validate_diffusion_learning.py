"""Diffusion-learning validation (port of the JAX package's
``tools/validate_diffusion_learning.py``): single-stage DiffusionNeRF
training (configs/paper_cfgs/ssdnerf_cars_uncond.py's model) on 8
analytic sphere scenes (6 views of 64^2 each); then unconditional samples
of the prior, whose codes' rms should approach the training codes' and
whose renders should show objects on the white background about as
often as the training views do.

    python -m ssdnerf_torch.tools.validate_diffusion_learning [--iters 800]
        [--device cpu] [--out samples.png]
"""
import argparse
import time

import numpy as np
import torch

from ..apis.inference import init_model, to_device
from ..config import Config
from ..core.png import write_png
from ..runner.hooks import EMAHook
from ..runner.optim import build_optimizers
from .synthetic import make_sphere_batch
from .validate_3d_learning import CONFIGS, empty_scenes, load_config, sync

FLAGSHIP = CONFIGS / 'ssdnerf_cars_uncond.py'
OPTIMIZERS = dict(diffusion=dict(type='Adam', lr=2e-4),
                  decoder=dict(type='Adam', lr=1e-3))


def sphere_model(device, config=FLAGSHIP, seed=0, **test_cfg):
    """``config``'s model (a path or a Config; the flagship uncond one by
    default) for 8 sphere scenes of 64^2, weights drawn from ``seed``, its
    test_cfg updated by ``test_cfg``."""
    base = load_config(config)
    tc = dict(base.train_cfg, extra_scene_step=3, loss_coef=0.1 / (64 * 64))
    tc.pop('cache_load_from', None)
    return init_model(Config._wrap(dict(
        model=dict(base.model, cache_size=8), train_cfg=tc,
        test_cfg=dict(base.test_cfg, **test_cfg))), device, seed=seed)


class _Runner:
    """What EMAHook reads of a runner."""

    def __init__(self, model):
        self.model = model
        self.iteration = 0


def train_spheres(model, data, iters, device, log=print, every=100,
                  seed=0):
    """``iters`` single-stage train steps on ``data`` (S scenes) from
    fresh codes, the EMA modules following (ema_kimg 4, rampup 0.05), the
    codes and the steps' draws seeded by ``seed``; returns the scene state
    (raw codes, density grids, bitfields)."""
    S = data['cond_imgs'].shape[0]
    opts, scheds = build_optimizers(model, OPTIMIZERS)
    code_ = torch.from_numpy(model.get_init_code_np(
        S, np.random.RandomState(seed))).to(device)
    batch = empty_scenes(model, code_)
    gen = torch.Generator(device=device).manual_seed(1 + seed)
    ema = EMAHook(momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05,
                                    batch_size=S))
    runner = _Runner(model)
    t0 = time.perf_counter()
    for i in range(iters):
        batch, logs = model.train_step(batch, data, opts, scheds,
                                       generator=gen)
        runner.iteration = i + 1
        ema.after_train_iter(runner)
        if i % every == 0:
            log('iter %d psnr=%.2f ddpm=%.4f diff=%.4f (%.2f it/s)' % (
                i, float(logs['train_psnr']), float(logs['loss_ddpm_mse']),
                float(logs['loss_diffusion']),
                (i + 1) / (time.perf_counter() - t0)))
    return batch


def object_fraction(img):
    """Share of pixels of each image (..., h, w, 3) farther than 0.15 from
    the white background in some channel."""
    return (np.abs(img - 1.0).max(-1) > 0.15).mean(axis=(-2, -1))


def main(iters=800, device='cuda', out=None, log=print, config=FLAGSHIP,
         sample_steps=20):
    """Train, sample 4 scenes with ``sample_steps`` sampler steps, render
    them; returns dict(train_code_rms, sample_code_rms,
    sample_object_fraction (per scene), train_object_fraction, train_s,
    iters)."""
    S, V = 8, 6
    model = sphere_model(device, config, num_timesteps=sample_steps)
    data_np = make_sphere_batch(num_scenes=S, num_views=V, h=64, w=64)
    data = {k: torch.from_numpy(v).to(device) for k, v in data_np.items()
            if k != 'scene_name'}
    sync(device)
    t0 = time.perf_counter()
    batch = train_spheres(model, data, iters, device, log)
    sync(device)
    train_s = time.perf_counter() - t0
    log('trained %d iterations in %.2f s' % (iters, train_s))
    code_train = model.code_activation(batch['code_'], model.code_act)
    train_rms = float(torch.sqrt(torch.mean(code_train ** 2)))
    log('train code rms: %.3f' % train_rms)

    d = to_device(model.val_draws(
        4, generator=torch.Generator().manual_seed(7)), device)
    code_s, _, bf_s = model.val_uncond(d['noise'], jitter=d['jitter'],
                                       draws=d['sample'], polish=d['polish'])
    sample_rms = float(torch.sqrt(torch.mean(code_s ** 2)))
    log('sample code rms: %.3f' % sample_rms)
    img, _ = model.render(
        code_s, bf_s, 64, 64,
        torch.from_numpy(data_np['cond_intrinsics'][:4, :1]).to(device),
        torch.from_numpy(data_np['cond_poses'][:4, :1]).to(device))
    img = np.clip(img.cpu().numpy(), 0, 1)
    frac = [float(f) for f in object_fraction(img[:, 0])]
    train_frac = float(object_fraction(data_np['cond_imgs'][:, 0]).mean())
    log('sampled object fraction per scene:', [round(f, 3) for f in frac])
    log('training object fraction: %.3f' % train_frac)
    if out:
        write_png(out, (np.concatenate(list(img[:, 0]), axis=1) * 255
                        ).astype(np.uint8))
        log('wrote', out)
    return dict(train_code_rms=train_rms, sample_code_rms=sample_rms,
                sample_object_fraction=frac,
                train_object_fraction=train_frac, train_s=train_s,
                iters=iters)


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=800)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None, help='PNG of the samples')
    a = ap.parse_args()
    main(a.iters, a.device, a.out, log=lambda *m: print(*m, flush=True))
