"""The guided-reconstruction validator's protocol in both packages at one
cut depth and config, to tell whether its margin over the unguided
control follows the package or the seed.

``jax`` runs ``tools/validate_guided_recon.py``'s protocol on the JAX
package (each mode once; the tool runs each twice, to compile and to
time) with the depth and seeds as arguments, seed ``s`` moving every
PRNG key and the code init as the port's ``--seed`` does; ``port`` runs
``ssdnerf_torch.tools.validate_guided_recon.run`` with the same depth.
``small`` writes the flagship config narrowed for a CPU run (codes
3x6x32², UNet base 32 x [1, 2, 2] with one resblock and attention at 8²;
grid, decoder and rays as shipped)::

    python tests/guided_recon_side_by_side.py small CFG
    JAX_PLATFORMS=cpu python tests/guided_recon_side_by_side.py jax CFG \\
        ITERS DDIM_STEPS OPTIM_STEPS SEED
    python tests/guided_recon_side_by_side.py port CFG ITERS DDIM_STEPS \\
        OPTIM_STEPS SEED [--device cpu]

Each prints ``RESULT <package> seed <s>: control, guide, guide_optim``
PSNRs (dB, 20 novel views) and the two margins.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))
FLAGSHIP = os.path.join(ROOT, 'configs', 'paper_cfgs',
                        'ssdnerf_cars_uncond.py')


def write_small(path):
    from ssdnerf_torch.config import Config
    cfg = Config.fromfile(FLAGSHIP)
    cfg.model.code_size = (3, 6, 32, 32)
    cfg.model.code_reshape = (18, 32, 32)
    cfg.model.diffusion.denoising.update(
        image_size=32, base_channels=32, channels_cfg=[1, 2, 2],
        resblocks_per_downsample=1, attention_res=[8], num_heads=4)
    with open(path, 'w') as f:
        f.write(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))


def report(package, seed, control, guide, guide_optim):
    print(f'RESULT {package} seed {seed}: control {control:.2f}, guide '
          f'{guide:.2f} ({guide - control:+.2f}), guide_optim '
          f'{guide_optim:.2f} ({guide_optim - control:+.2f})', flush=True)


def run_jax(cfg_path, iters, steps, optim_steps, seed):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ssdnerf_tpu.config import Config
    from ssdnerf_tpu.core.metrics import eval_psnr
    from ssdnerf_tpu.models.autodecoders.base import adam_init
    from ssdnerf_tpu.registry import build_model
    from ssdnerf_tpu.runner.hooks import EMAHook
    from synthetic import make_sphere_batch

    base = Config.fromfile(cfg_path)
    tc = dict(base.train_cfg, extra_scene_step=3, loss_coef=0.1 / (64 * 64))
    tc.pop('cache_load_from', None)
    S, V, S_test = 8, 6, 4
    test_cfg = dict(base.test_cfg, num_timesteps=steps, img_size=(64, 64),
                    loss_coef=0.1 / (64 * 64), n_inverse_rays=4096,
                    n_inverse_steps=optim_steps, extra_scene_step=3,
                    dt_gamma_scale=0.5,
                    optimizer=dict(type='Adam', lr=5e-3),
                    lr_scheduler=dict(type='ExponentialLR', gamma=0.998),
                    guidance_gain=3.2 * 4096,
                    override_cfg={
                        'diffusion_ema.ddpm_loss.weight_scale': 1.0},
                    cond_mode='guide_optim')
    test_cfg.pop('march_slots', None)
    model = build_model(dict(base.model, cache_size=S), train_cfg=tc,
                        test_cfg=test_cfg)
    data_np = make_sphere_batch(num_scenes=S, num_views=V, h=64, w=64,
                                ss=4, texture=True)
    data = {k: jnp.asarray(v) for k, v in data_np.items()
            if k != 'scene_name'}
    opt_cfgs = dict(diffusion=dict(type='Adam', lr=2e-4),
                    decoder=dict(type='Adam', lr=1e-3))
    state = model.init_state(jax.random.PRNGKey(seed), opt_cfgs)
    tx_d = model.make_optimizer(opt_cfgs['diffusion'], None, 'x')
    tx_dec = model.make_optimizer(opt_cfgs['decoder'], None, 'x')
    code_ = jnp.asarray(model.get_init_code_np(
        S, np.random.RandomState(seed)))
    batch = dict(code_=code_, opt=adam_init(code_),
                 density_grid=jnp.zeros((S, 64 ** 3), jnp.float16),
                 density_bitfield=jnp.full((S, 64 ** 3 // 8), 255,
                                           jnp.uint8))
    step = jax.jit(lambda s, b, d, k: model.train_step(s, b, d, k,
                                                       tx_d, tx_dec))

    class Runner:
        iteration = 0
    ema = EMAHook(momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05,
                                    batch_size=S))
    runner = Runner()
    runner.state = state
    t0 = time.time()
    for i in range(iters):
        runner.state, batch, logs = step(
            runner.state, batch, data,
            jax.random.fold_in(jax.random.PRNGKey(1 + seed), i))
        runner.iteration = i + 1
        ema.after_train_iter(runner)
    state = runner.state
    print(f'training done in {time.time() - t0:.0f} s', flush=True)

    held = make_sphere_batch(num_scenes=S_test, num_views=V, h=64, w=64,
                             seed=99, ss=4, texture=True)
    recon = {k: jnp.asarray(held[k][:, :1]) for k in (
        'cond_imgs', 'cond_poses', 'cond_intrinsics')}
    noise = jax.random.normal(jax.random.PRNGKey(42 + seed),
                              (S_test,) + model.code_size)
    recon['noise'] = noise
    gt = jnp.asarray(held['cond_imgs'][:, 1:].reshape(-1, 64, 64, 3)
                     .transpose(0, 3, 1, 2))

    def psnr(out):
        img, _ = model.render(state, out[0], out[2], 64, 64,
                              jnp.asarray(held['cond_intrinsics'][:, 1:]),
                              jnp.asarray(held['cond_poses'][:, 1:]))
        pred = np.clip(np.asarray(img), 0, 1)
        return float(np.asarray(eval_psnr(jnp.asarray(
            pred.reshape(-1, 64, 64, 3).transpose(0, 3, 1, 2)), gt)).mean())

    key = jax.random.PRNGKey(5 + seed)
    model.eval_mode()
    control = psnr(model.val_uncond(state, noise, key))
    model.test_cfg['cond_mode'] = 'guide'
    guide = psnr(model.val_step(state, recon, key))
    model.test_cfg['cond_mode'] = 'guide_optim'
    guide_optim = psnr(model.val_step(state, recon, key))
    report('jax', seed, control, guide, guide_optim)


def run_port(cfg_path, iters, steps, optim_steps, seed, device):
    from ssdnerf_torch.tools import validate_guided_recon as tool
    tool.TEST_CFG.update(num_timesteps=steps, n_inverse_steps=optim_steps)
    out = tool.run(iters, device, ceiling=False, config=cfg_path, seed=seed,
                   log=lambda *m: print(*m, flush=True))
    report('port', seed, *(out[k]['psnr'] for k in (
        'uncond', 'guide', 'guide_optim')))


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('package', choices=('small', 'jax', 'port'))
    ap.add_argument('config')
    ap.add_argument('depth', type=int, nargs='*',
                    help='iterations, DDIM steps, optimisation steps, seed')
    ap.add_argument('--device', default='cpu')
    a = ap.parse_args()
    if a.package == 'small':
        write_small(a.config)
    elif a.package == 'jax':
        run_jax(a.config, *a.depth)
    else:
        run_port(a.config, *a.depth, a.device)
