"""The data-parallel path in N ranks (the port's counterpart of the JAX
package's ``dryrun_multichip``):

    python -m ssdnerf_torch.parallel.dryrun N [--device cpu] [--backend B]
        [--steps 40] [--timeout S]

spawns N ranks joined by ``torch.distributed`` (gloo on the CPU, NCCL on
cards unless ``--backend`` names gloo: two ranks on one card need it;
rank r on ``cuda:r % device_count``).  Each rank

1. allocates its shard of the 2458-scene 16-bit scene bank (SRN cars'
   training set) and prints its size;
2. takes ``--steps`` flagship-config ``DiffusionNeRF.train_step``s of its
   share of a max(N, 2)-scene batch (its bank rows, 2 views of 16^2 of
   analytic sphere scenes), in which the train PSNR must rise: the mean
   of the last quarter of the steps 0.3 dB over the first quarter's;
3. runs ``--steps`` steps of the diffusion half alone (stage 2, Adam at
   2e-3 on the CPU as the JAX dryrun, at the flagship config's 1e-4 on a
   card) on fixed noisy codes, whose diffusion loss (the scale-norm
   factor multiplied back) on 8 held draws of timesteps and noise must
   fall.

On the CPU the model is the tests' tiny configuration (codes 3x4x16^2,
UNet base 32); on a card it is ``configs/paper_cfgs/ssdnerf_cars_uncond.py``
at full width with one inner step and 1024-ray batches, as the JAX
dryrun's step takes it.  A rank whose check fails raises, and the run
exits non-zero.  Rank 0 prints ``dryrun(N): OK, ...`` last.
"""
import argparse
import datetime
import os
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..models.autodecoders.multiscene import DeviceSceneCache
from ..registry import build_model
from ..runner.optim import build_optimizers
from ..tools.synthetic import make_sphere_batch
from .sharding import init_distributed, replicate, shard_scenes, shutdown

FLAGSHIP = Path(__file__).resolve().parents[2] / 'configs' / \
    'paper_cfgs' / 'ssdnerf_cars_uncond.py'
BANK_SCENES = 2458          # SRN cars' training scenes
EVAL_DRAWS = 8              # held (timestep, noise) draws of step 3

# the tests' tiny configuration (the repository's tests/synthetic.py)
TINY_MODEL_CFG = dict(
    type='DiffusionNeRF',
    code_size=(3, 4, 16, 16),
    code_reshape=(12, 16, 16),
    code_activation=dict(type='TanhCode', scale=2),
    grid_size=16,
    diffusion=dict(
        type='GaussianDiffusion',
        num_timesteps=20,
        betas_cfg=dict(type='linear'),
        denoising=dict(
            type='DenoisingUnetMod', image_size=16, in_channels=12,
            base_channels=32, channels_cfg=[1, 2],
            resblocks_per_downsample=1, dropout=0.0,
            use_scale_shift_norm=True, downsample_conv=True,
            upsample_conv=True, num_heads=2, attention_res=[8]),
        timestep_sampler=dict(type='SNRWeightedTimeStepSampler', power=0.5),
        ddpm_loss=dict(
            type='DDPMMSELossMod', rescale_mode='timestep_weight',
            log_cfgs=dict(type='quartile', prefix_name='loss_mse',
                          total_timesteps=20),
            data_info=dict(pred='v_t_pred', target='v_t'),
            weight_scale=4.0, scale_norm=True)),
    decoder=dict(
        type='TriPlaneDecoder', interp_mode='bilinear',
        base_layers=[4 * 3, 32], density_layers=[32, 1],
        color_layers=[32, 3], use_dir_enc=True, dir_layers=[16, 32],
        activation='silu', sigma_activation='trunc_exp',
        sigmoid_saturation=0.001, max_steps=32),
    decoder_use_ema=True, freeze_decoder=False, bg_color=1,
    pixel_loss=dict(type='MSELoss', loss_weight=20.0),
    reg_loss=dict(type='RegLoss', power=2, loss_weight=3e-3),
    cache_size=4)
TINY_TRAIN_CFG = dict(
    dt_gamma_scale=0.5, density_thresh=0.1, extra_scene_step=2,
    n_inverse_rays=128, n_decoder_rays=128, loss_coef=0.1 / (16 * 16),
    optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))


def build(device, seed=0):
    """The dryrun's model on ``device``: tiny on the CPU, the flagship's
    widths on a card; weights from ``seed``."""
    if device.type == 'cpu':
        model_cfg, train_cfg = TINY_MODEL_CFG, TINY_TRAIN_CFG
    else:
        cfg = Config.fromfile(str(FLAGSHIP))
        model_cfg = cfg.model
        train_cfg = dict(cfg.train_cfg, extra_scene_step=1,
                         n_inverse_rays=2 ** 10, n_decoder_rays=2 ** 10)
        train_cfg.pop('cache_load_from', None)
    with torch.device('meta'):
        model = build_model(model_cfg, train_cfg=train_cfg, test_cfg={})
    model = model.to_empty(device='cpu')
    model.init_weights(torch.Generator().manual_seed(seed))
    model.reset_ema()
    return model.to(device).train()


def quarter_means(values, q):
    return float(np.mean(values[:q])), float(np.mean(values[-q:]))


def run_rank(rank, world_size, port, device_kind, backend, steps, timeout):
    """One rank of the dryrun (its checks raise)."""
    if device_kind == 'cuda':
        device = torch.device('cuda', rank % torch.cuda.device_count())
    else:
        device = torch.device('cpu')
        torch.set_num_threads(max(1, min(2, os.cpu_count() // world_size)))
    group = init_distributed(
        device, backend, rank, world_size,
        init_method=f'tcp://localhost:{port}',
        timeout=datetime.timedelta(seconds=timeout))
    log = print if rank == 0 else (lambda *a, **k: None)
    try:
        model = build(device, seed=rank)   # ranks seeded apart ...
        replicate(model, group)            # ... start from rank 0's weights
        model.group = group
        log(f'dryrun: {world_size} ranks, backend {group.backend}, '
            f'{device_kind}, codes {model.code_size}', flush=True)

        cache = DeviceSceneCache(BANK_SCENES, model.code_size,
                                 model.grid_size, device, cache_16bit=True,
                                 rank=rank, world_size=world_size)
        nbytes = sum(getattr(cache, k).numel()
                     * getattr(cache, k).element_size() for k in cache.KEYS)
        print(f'dryrun rank {rank}: bank shard [{cache.offset}, '
              f'{cache.offset + cache.local_size}) of {BANK_SCENES}, 16-bit, '
              f'{nbytes / 2 ** 20:.1f} MiB', flush=True)

        num_scenes = max(world_size, 2)
        if num_scenes % world_size:
            raise ValueError(f'{num_scenes} scenes over {world_size} ranks')
        batch = make_sphere_batch(num_scenes, num_views=2, h=16, w=16)
        mine = shard_scenes({k: batch[k] for k in (
            'cond_imgs', 'cond_poses', 'cond_intrinsics')}, rank, world_size)
        data = {k: torch.from_numpy(v).to(device) for k, v in mine.items()}
        init = shard_scenes(model.get_init_code_np(
            num_scenes, np.random.RandomState(0)), rank, world_size)
        ids = cache.offset + np.arange(len(init))
        idx = torch.as_tensor(ids - cache.offset, device=device)
        cache.ensure_init(ids, lambda n: init)
        with torch.no_grad():
            cache.density_bitfield[idx] = 255

        optimizers, schedulers = build_optimizers(model, dict(
            diffusion=dict(type='Adam', lr=1e-4),
            decoder=dict(type='Adam', lr=1e-3)), None)
        losses, psnrs = [], []
        for i in range(steps):
            gen = torch.Generator(device=device).manual_seed(
                1000 * (rank + 1) + i)
            scene_batch, logs = model.train_step(
                cache.load(ids), data, optimizers, schedulers, generator=gen)
            cache.save(ids, scene_batch['code_'], scene_batch['opt'],
                       scene_batch['density_grid'],
                       scene_batch['density_bitfield'])
            losses.append(float(logs['loss_diffusion']))
            psnrs.append(float(logs['train_psnr']))
        p_first, p_last = quarter_means(psnrs, max(steps // 4, 1))
        log(f'dryrun: {steps} bank steps: loss_diffusion {losses[0]:.4f} -> '
            f'{losses[-1]:.4f}, train_psnr {psnrs[0]:.2f} -> '
            f'{psnrs[-1]:.2f} (quarters {p_first:.2f} -> {p_last:.2f})',
            flush=True)
        if not p_last > p_first + 0.3:
            raise AssertionError(f'train PSNR did not rise over {steps} '
                                 f'steps: {p_first:.2f} -> {p_last:.2f}')

        # the diffusion half on fixed codes (stage 2: no scene batch),
        # trained with fresh draws each step; its loss is measured on all
        # the codes with fixed evaluation draws before and after
        lr = 2e-3 if device.type == 'cpu' else 1e-4
        opt2, _ = build_optimizers(model, dict(
            diffusion=dict(type='Adam', lr=lr),
            decoder=dict(type='Adam', lr=1e-3)), None)
        rng = np.random.RandomState(3)
        code_ = torch.from_numpy(model.get_init_code_np(num_scenes, rng))
        noise = torch.from_numpy(rng.randn(*code_.shape).astype(np.float32))
        with torch.no_grad():
            code = model.code_activation(code_.to(device), model.code_act) \
                + 0.5 * noise.to(device)
        data2 = dict(code=shard_scenes(code, rank, world_size))
        gen = torch.Generator(device=device).manual_seed(9)
        x0 = model.code_diff_pr(code)
        held = [(model.diffusion.timestep_sampler.sample(num_scenes, gen,
                                                         device),
                 torch.randn(x0.shape, generator=gen, device=device))
                for _ in range(EVAL_DRAWS)]

        @torch.no_grad()
        def held_loss():
            """The diffusion loss of every code on the held draws, the
            scale-norm factor multiplied back."""
            norm = model.diffusion.norm_factor
            return float(np.mean([float(model.diffusion.forward_train(
                x0, t=t, noise=n, update_norm=False)[0] * norm[0])
                for t, n in held]))

        d_first = held_loss()
        for i in range(steps):
            gen = torch.Generator(device=device).manual_seed(
                7000 * (rank + 1) + i)
            model.train_step(None, data2, opt2, generator=gen)
        d_last = held_loss()
        log(f'dryrun: {steps} fixed-code stage-2 steps (Adam lr {lr:g}): '
            f'the diffusion loss on {EVAL_DRAWS} held draws of the '
            f'{num_scenes} codes {d_first:.4f} -> {d_last:.4f}', flush=True)
        if not d_last < d_first:
            raise AssertionError(f'the diffusion half did not learn: '
                                 f'{d_first:.4f} -> {d_last:.4f}')
        # the ranks hold one set of weights
        digest = torch.stack([p.detach().double().sum() for p in
                              model.parameters()])
        if not all(torch.equal(g, digest) for g in group.all_gather(digest)):
            raise AssertionError('the ranks\' weights differ')
        log(f'dryrun({world_size}): OK, loss_diffusion={losses[-1]:.4f}, '
            f'train_psnr={psnrs[-1]:.2f}, stage2_denorm_loss '
            f'{d_first:.4f}->{d_last:.4f}', flush=True)
    finally:
        shutdown()


def _spawned(rank, *args):
    run_rank(rank, *args)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('ranks', type=int, nargs='?', default=2)
    parser.add_argument('--device', choices=('cpu', 'cuda'), default='cuda')
    parser.add_argument('--backend', choices=('nccl', 'gloo'), default=None)
    parser.add_argument('--steps', type=int, default=40)
    parser.add_argument('--timeout', type=float, default=600.0,
                        help='seconds a collective may wait')
    args = parser.parse_args(argv)
    import torch.multiprocessing as mp
    from ..train import free_port
    mp.spawn(_spawned, args=(args.ranks, free_port(), args.device,
                             args.backend, args.steps, args.timeout),
             nprocs=args.ranks, join=True)


if __name__ == '__main__':
    main()
