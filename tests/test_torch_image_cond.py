"""The port's image conditioning and ``x_t_detach`` vs the JAX package on
the CPU: the ``concat_cond`` UNet, ``train_step`` with ``image_cond`` (one
drawn view a scene concatenated to the UNet's input) with and without
``x_t_detach``, and ``val_step`` in 'guide_optim' with ``image_cond``
(every view, in a drawn order a scene, one a UNet call) and
``test_cfg.x_t_detach``, each with every draw of JAX's key tree replayed.

The JAX side runs as its own tests run it on the CPU: the XLA renderer
with an f32 decoder.  The port runs its plain versions (CPU tensors).

JAX's ``GaussianDiffusion.forward_train`` takes ``concat_cond`` but does
not hand it to ``pred_x_0``, so its UNet concatenates None and its
``image_cond`` training and ``val_optim`` fail (ROADMAP section 3 item 17;
pinned here).  The oracle of these tests is JAX's with that one argument
forwarded (:func:`_forward_train_with_cond`, patched in for a test; the JAX
package is not changed); the port forwards it."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_recons as recons
from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_tiled import (_hold_f32, _jax_grads, _max_rel, _port_grads,
                              _unet_pair)
from test_torch_train import _compare_module, _jax_step_draws
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_tpu.models.diffusions.gaussian_diffusion import (
    GaussianDiffusion as JDiffusion)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import load_jax_params
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)
S, V, H, W = 2, 2, 16, 16
P = V * H * W
ESS, INTERVAL, N_RAYS = 1, 1, 128
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                 extra_scene_step=ESS, n_inverse_rays=N_RAYS,
                 n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
OPT_CFGS = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))
# single-view reconstruction's test_cfg at the tiny size, with two views
# a scene and test-time x_t_detach
TEST_CFG = dict(recons.RECONS_CFG, num_timesteps=2, n_inverse_steps=3,
                n_inverse_rays=P, loss_coef=0.1 / P, guidance_gain=0.05 * P,
                x_t_detach=True)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _forward_train_with_cond(self, params, x_0, key, loss_state,
                             concat_cond=None, x_t_detach=False, cfg=None,
                             update_norm=True, deterministic=True,
                             dropout_key=None):
    """``ssdnerf_tpu``'s ``GaussianDiffusion.forward_train``, line for
    line, with ``concat_cond`` handed to ``pred_x_0``."""
    num_batches = x_0.shape[0]
    t_key, n_key = jax.random.split(key)
    t = self.timestep_sampler.sample(t_key, num_batches)
    noise = jax.random.normal(n_key, x_0.shape, x_0.dtype)
    x_t, mean, std = self.q_sample(x_0, t, noise)
    if x_t_detach:
        x_t = jax.lax.stop_gradient(x_t)
    _, out, _ = self.pred_x_0(
        params, x_t, t, cfg=cfg, concat_cond=concat_cond,
        update_denoising_output=True, deterministic=deterministic,
        dropout_key=dropout_key)
    assert self.denoising_mean_mode.upper() == 'V'
    target = mean * noise - std * x_0
    return self.ddpm_loss(out, target, t, x_0, state=loss_state,
                          update_norm=update_norm)


@pytest.fixture
def cond_oracle(monkeypatch):
    monkeypatch.setattr(JDiffusion, 'forward_train', _forward_train_with_cond)


def test_concat_cond_unet_matches_flax():
    """tests/test_diffusion.py's concat-cond UNet (6 input channels and 3
    of condition, the input convolution over both) against the Flax UNet:
    output, input gradient and parameter gradients as
    ``test_torch_tiled._hold_f32`` says; the condition's share of the input
    convolution's gradient is live."""
    kw = dict(image_size=(16, 16), in_channels=6, concat_cond_channels=3,
              base_channels=32, channels_cfg=(1, 2),
              resblocks_per_downsample=1, num_heads=2, attention_res=(8,))
    jm, params, tm = _unet_pair(9, **kw)
    assert tm.in_conv.in_channels == 9
    rng = np.random.RandomState(10)
    x = rng.randn(2, 6, 16, 16).astype(np.float32)
    cond = rng.rand(2, 3, 16, 16).astype(np.float32)
    w = rng.randn(2, 6, 16, 16).astype(np.float32)
    t = np.array([7, 420])
    got = _port_grads(tm, x, t, w, cond)
    _hold_f32(got, _jax_grads(jm, params, tm, x, t, w, cond), tm,
              'concat-cond UNet')
    assert np.abs(got[2][2][:, 6:]).max() > 0   # in_conv.weight, cond part


def _cfg():
    """The tiny model with ``image_cond``: a UNet of 12 + 3 input channels
    (the codes and one 16^2 view), an f32 decoder."""
    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), image_cond=True,
               update_extra_interval=INTERVAL)
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg['diffusion']['denoising']['concat_cond_channels'] = 3
    return cfg


@pytest.fixture(scope='module')
def trees():
    """The JAX state of the image-conditioned tiny model (its init plus
    N(0, 0.02), a density head that leaves part of each grid empty), live
    and EMA trees alike."""
    jm = _jax_model(TRAIN_CFG, {})
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS)
    state = jax.jit(lambda k: jm.init_state(k, OPT_CFGS, schedules))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(80)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = recons._noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = tree[name]
    dens = tree['decoder']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    return dict(state, **jax.tree_util.tree_map(jnp.asarray, tree)), tree, \
        txs


def _jax_model(train_cfg, test_cfg):
    jcfg = _cfg()
    jcfg['decoder'].update(backend='xla')
    return jax_build_model(jcfg, train_cfg=train_cfg, test_cfg=test_cfg)


def _port(tree, train_cfg, test_cfg):
    tm = build_model(_cfg(), train_cfg=train_cfg, test_cfg=test_cfg)
    load_jax_params(tm, tree)
    return tm


def _data(seed):
    d = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


@pytest.mark.parametrize('x_t_detach', [False, True])
def test_image_cond_train_step_matches_jax(trees, cond_oracle, x_t_detach):
    """One ``train_step`` with ``image_cond`` (the UNet reads one view a
    scene, JAX's ``randint`` draw replayed as ``cond_view``), without and
    with ``train_cfg.x_t_detach``, against JAX's with every draw replayed:
    losses rtol 1e-4; the codes' and the UNet's Adam moments max-normalised
    atol 2e-3; codes atol 2e-4, 2% of an Adam step (lr 1e-2: Adam divides
    each entry by its own RMS, so an entry ~1e-4 of the largest, whose f32
    differences the moments' bound admits, moves by up to ~1% of a step
    over the step's two code updates); the input convolution's condition
    channels trained.  With ``x_t_detach`` the UNet's input carries no
    gradient to the codes (it is not part of the autograd graph), so the
    prior gradient reaches them only through the loss's target."""
    state, tree, txs = trees
    tc = dict(TRAIN_CFG, x_t_detach=x_t_detach)
    jm = _jax_model(tc, {})
    tm = _port(tree, tc, {})
    jdata, tdata = _data(81)
    code0 = (np.random.RandomState(82).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=torch.from_numpy(grid0),
                  density_bitfield=torch.from_numpy(bits0))
    key = jax.random.PRNGKey(83 + x_t_detach)
    new_state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(state, jbatch, jdata,
                                                       key)
    draws = _jax_step_draws(jm, key, P, S, ESS, INTERVAL, N_RAYS)
    k_cond = jax.random.split(key, 8)[1]
    draws['cond_view'] = torch.from_numpy(np.array(
        jax.random.randint(k_cond, (S,), 0, V))).long()
    inputs = []
    tm.diffusion.denoising.register_forward_hook(
        lambda m, args, out: inputs.append(args[0].requires_grad))
    opts, scheds = build_optimizers(tm, OPT_CFGS)
    tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds, draws=draws)
    assert inputs == [not x_t_detach]
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                 'train_psnr'):
        np.testing.assert_allclose(np.asarray(tlogs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-4,
                                   err_msg=name)
    for a, b, name in ((tbatch['opt'].m, jbatch['opt'].m, 'code m'),
                       (tbatch['opt'].v, jbatch['opt'].v, 'code v')):
        assert _max_rel(a.numpy(), b) <= 2e-3, name
    np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                               rtol=0, atol=2e-4)
    mu = jax.tree_util.tree_leaves(
        new_state['opt_diffusion'], is_leaf=lambda s: hasattr(s, 'mu'))
    mu = next(s for s in mu if hasattr(s, 'mu')).mu
    unet = tm.diffusion.denoising
    moments = [opts['diffusion'].state[p]['exp_avg'] for p in
               unet.parameters()]
    _compare_module(unet, [m.numpy() for m in moments], mu, 'unet m', 2e-3)
    cond_m = opts['diffusion'].state[unet.in_conv.weight]['exp_avg'][:, 12:]
    assert cond_m.abs().max() > 0


def test_image_cond_val_step_matches_jax(trees, cond_oracle, monkeypatch):
    """``val_step`` in 'guide_optim' with ``image_cond`` and
    ``test_cfg.x_t_detach``: 2 guided DDIM steps whose UNet calls read the
    two views of each scene in the scene's drawn order (JAX's per-scene
    ``permutation``, replayed as ``cond_perm``), then 3 ``val_optim`` outer
    steps, step i reading view i % 2 of that order, against JAX's with
    every draw replayed: codes atol 5e-5, grids and bitfields as
    ``test_torch_recons._compare_outputs`` says."""
    state, tree, _ = trees
    monkeypatch.setattr(recons, 'P', P)
    jm = _jax_model({}, TEST_CFG)
    tm = _port(tree, {}, TEST_CFG)
    with torch.no_grad():
        tm.diffusion.norm_factor.fill_(float(state['ddpm_loss'][0]))
    jdata, tdata = _data(84)
    key = jax.random.PRNGKey(85)
    ref = jm.val_step(state, jdata, key)
    key2, k_noise = jax.random.split(key)
    k_cond = jax.random.split(key2, 3)[1]
    perm = jax.vmap(lambda k: jax.random.permutation(k, V))(
        jax.random.split(k_cond, S))
    draws = dict(noise=_t(jax.random.normal(k_noise, (S,) + jm.code_size)),
                 cond_perm=torch.from_numpy(np.array(perm)).long(),
                 **recons._guide_draws(jm, key2, TEST_CFG['num_timesteps']),
                 **recons._optim_draws(jm, key2, with_init=False))
    assert sorted(draws['cond_perm'][0].tolist()) == [0, 1]
    got = tm.val_step(tdata, draws)
    recons._compare_outputs(got, ref, 5e-5, 'image_cond val_step')
    flipped = tm.val_step(tdata, dict(draws,
                                      cond_perm=draws['cond_perm'].flip(1)))
    assert (flipped[0] - got[0]).abs().max() > 1e-3


def test_jax_image_cond_training_drops_the_condition(trees):
    """The JAX package as it is: its ``forward_train`` drops
    ``concat_cond``, so an ``image_cond`` train step fails where the UNet
    concatenates it (ROADMAP section 3 item 17); the port runs the step
    (``test_image_cond_train_step_matches_jax``)."""
    state, _, txs = trees
    jm = _jax_model(TRAIN_CFG, {})
    jdata, _ = _data(86)
    code0 = jnp.zeros((S,) + tuple(jm.code_size))
    jbatch = dict(code_=code0, opt=jax_adam_init(code0),
                  density_grid=jnp.zeros((S, jm.grid_size ** 3), jnp.float16),
                  density_bitfield=jnp.zeros((S, jm.grid_size ** 3 // 8),
                                             jnp.uint8))
    with pytest.raises(TypeError, match='concatenate'):
        jm.train_step(state, jbatch, jdata, jax.random.PRNGKey(87),
                      txs['diffusion'], txs['decoder'])
