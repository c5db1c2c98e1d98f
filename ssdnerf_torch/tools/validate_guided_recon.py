"""Guided-reconstruction validation (port of the JAX package's
``tools/validate_guided_recon.py``): single-view reconstruction by
reconstruction-guided DDIM ('guide') and guided DDIM followed by code
optimisation ('guide_optim'), the test path of the recons1v configs.

Trains single-stage on 8 textured, anti-aliased sphere scenes (the
``validate_diffusion_learning`` recipe), then reconstructs 4 held-out
sphere scenes from one conditioning view each and scores PSNR on their 5
other views.  The control runs the same sampler from the same noise
without guidance: it renders a sphere of the learned prior, not the
sphere seen, so guidance must beat it by 2 dB ('guide' and
'guide_optim'), and the optimisation may lose at most 0.5 dB to the guide
alone.  A last 'guide_optim' run conditioned on all 6 views gives the
ceiling of the 1-view PSNR.  ``seed`` moves every seed of the run: the
weights, the training codes and draws, the sampling noise and the
reconstruction's draws (the sphere scenes stay).

    python -m ssdnerf_torch.tools.validate_guided_recon [--iters 800]
        [--device cpu] [--no-ceiling] [--seed 0]
"""
import argparse
import time

import torch

from ..apis.inference import to_device
from ..core.metrics import eval_psnr
from .synthetic import make_sphere_batch
from .validate_3d_learning import sync
from .validate_diffusion_learning import (FLAGSHIP, sphere_model,
                                          train_spheres)

# guide / optim settings of ssdnerf_cars_recons1v.py's test_cfg, scaled to
# the 4096-ray batches of 64^2 views
TEST_CFG = dict(num_timesteps=75, img_size=(64, 64),
                loss_coef=0.1 / (64 * 64), n_inverse_rays=4096,
                n_inverse_steps=25, extra_scene_step=3,
                dt_gamma_scale=0.5,
                optimizer=dict(type='Adam', lr=5e-3),
                lr_scheduler=dict(type='ExponentialLR', gamma=0.998),
                guidance_gain=3.2 * 4096,
                # the reference's finetuning prior weight (recons1v's
                # override_cfg): the training weight_scale 4 would pull the
                # codes towards the prior mean during optim
                override_cfg={'diffusion_ema.ddpm_loss.weight_scale': 1.0},
                cond_mode='guide_optim')


def run(iters=800, device='cuda', ceiling=True, log=print,
        config=FLAGSHIP, seed=0):
    """Train ``config``'s model, then reconstruct in each mode.  Returns
    {mode: dict(psnr, s)}, 'train_s' and 'failed', the checks that do not
    hold."""
    S, V, S_test = 8, 6, 4
    model = sphere_model(device, config, seed, **TEST_CFG)
    model.test_cfg.pop('march_slots', None)  # untrained grids are unpruned
    # ss=4 anti-aliases the silhouettes (hard ones cap novel-view PSNR
    # near 21 dB whatever the reconstruction); texture adds latitude bands
    data_np = make_sphere_batch(num_scenes=S, num_views=V, h=64, w=64,
                                ss=4, texture=True)
    data = {k: torch.from_numpy(v).to(device) for k, v in data_np.items()
            if k != 'scene_name'}
    sync(device)
    t0 = time.perf_counter()
    train_spheres(model, data, iters, device, log, every=200, seed=seed)
    sync(device)
    out = dict(train_s=time.perf_counter() - t0)
    log(f'training done in {out["train_s"]:.0f} s')

    held = make_sphere_batch(num_scenes=S_test, num_views=V, h=64, w=64,
                             seed=99, ss=4, texture=True)
    held = {k: torch.from_numpy(v).to(device) for k, v in held.items()
            if k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    recon = {k: v[:, :1] for k, v in held.items()}
    g = torch.Generator().manual_seed(42 + seed)
    noise = torch.randn((S_test,) + model.code_size, generator=g).to(device)
    gt = held['cond_imgs'][:, 1:].reshape(-1, 64, 64, 3).permute(0, 3, 1, 2)

    def psnr_of(code, bitfield):
        img, _ = model.render(code, bitfield, 64, 64,
                              held['cond_intrinsics'][:, 1:],
                              held['cond_poses'][:, 1:])
        pred = img.clamp(0, 1).reshape(-1, 64, 64, 3).permute(0, 3, 1, 2)
        return float(eval_psnr(pred, gt).mean())

    def run(tag, fn):
        sync(device)
        t = time.perf_counter()
        code, _, bitfield = fn()
        sync(device)
        dt = time.perf_counter() - t
        psnr = psnr_of(code, bitfield)
        log(f'{tag}: PSNR {psnr:.2f} dB on {S_test * (V - 1)} novel views '
            f'| {dt:.2f} s / batch-{S_test} = {S_test / dt:.2f} scenes/s')
        out[tag] = dict(psnr=psnr, s=dt)

    model.eval_mode()   # test_cfg.override_cfg (weight_scale 1)
    uncond = to_device(model.val_draws(S_test, generator=g), device)
    run('uncond', lambda: model.val_uncond(
        noise, jitter=uncond['jitter'], draws=uncond['sample'],
        polish=uncond['polish']))
    gen = torch.Generator(device=device).manual_seed(5 + seed)
    for mode in ('guide', 'guide_optim'):
        model.test_cfg['cond_mode'] = mode
        run(mode, lambda: model.val_step(dict(recon, noise=noise),
                                         generator=gen))
    if ceiling:
        run('all-view guide_optim (ceiling)', lambda: model.val_step(
            dict(held, noise=noise), generator=gen))

    base, g_psnr, go_psnr = (out[k]['psnr'] for k in (
        'uncond', 'guide', 'guide_optim'))
    checks = ((g_psnr > base + 2.0, 'guide does not beat the control by '
               '2 dB'),
              (go_psnr > base + 2.0, 'guide_optim does not beat the '
               'control by 2 dB'),
              (go_psnr >= g_psnr - 0.5, 'guide_optim loses more than 0.5 '
               'dB to guide'))
    summary = (f'guide {g_psnr:.2f}, guide_optim {go_psnr:.2f}, control '
               f'{base:.2f} dB')
    out['failed'] = [what for ok, what in checks if not ok]
    log(('FAILED: ' + '; '.join(out['failed']) if out['failed'] else
         'OK: guidance beats the control') + f' ({summary})')
    return out


def main(iters=800, device='cuda', ceiling=True, log=print,
         config=FLAGSHIP, seed=0):
    """:func:`run`, raising AssertionError when a check does not hold."""
    out = run(iters, device, ceiling, log, config, seed)
    if out['failed']:
        raise AssertionError('; '.join(out['failed']))
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=800)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--no-ceiling', action='store_true')
    ap.add_argument('--seed', type=int, default=0)
    a = ap.parse_args()
    main(a.iters, a.device, not a.no_ceiling,
         log=lambda *m: print(*m, flush=True), seed=a.seed)
