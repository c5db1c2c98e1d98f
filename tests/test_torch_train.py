"""The port's training slice vs the JAX package on the CPU: the attention
and decode backward, render gradients with the start-t perturbation, the
diffusion loss, and two whole ``train_step``s with every random draw of
JAX's key tree replayed into the port.

The JAX side runs as its own tests run it on the CPU: the XLA renderer with
an f32 decoder, and the Pallas kernels in interpret mode.  The port runs
its plain versions (CPU tensors)."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from ssdnerf_tpu.models.architecture.unet import SelfAttention as JSelfAttn
from ssdnerf_tpu.models.autodecoders.base import (
    adam_init as jax_adam_init, make_raybatch_indices)
from ssdnerf_tpu.models.decoders.renderer import (
    volume_render as jax_volume_render)
from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDecoder
from ssdnerf_tpu.ops import packbits
from ssdnerf_tpu.ops.pallas.attention import vmem_attention
from ssdnerf_tpu.ops.pallas.decode import triplane_decode
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import load_jax_params, load_params
from ssdnerf_torch.models.autodecoders.base import (adam_init, adam_step,
                                                  code_adam_cfg)
from ssdnerf_torch.models.architecture.unet import SelfAttention
from ssdnerf_torch.models.decoders.renderer import volume_render
from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops.kernels import attention as tattn
from ssdnerf_torch.ops.kernels import decode as tdec
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.array(a)


def _max_normalised(a, b, name, atol):
    """|a - b| / max|b| <= atol, the comparison of the JAX package's own
    gradient tests (errors of a gradient scale with its largest entry)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol,
                               err_msg=name)


def _compare_module(module, values, ref_tree, name, atol):
    """``values`` (one per parameter of ``module``, in its order) vs the
    JAX tree ``ref_tree`` read into a copy of the module, each
    max-normalised.  A gradient that is zero in exact arithmetic (a conv
    bias right before a one-channel-per-group GroupNorm) is rounding noise
    on both sides, so no scale is taken below 1e-3 of the module's
    largest entry."""
    ref = copy.deepcopy(module)
    load_params(ref, jax.tree_util.tree_map(_np, ref_tree))
    refs = [r.detach().numpy().astype(np.float64) for r in ref.parameters()]
    floor = 1e-3 * max(np.abs(r).max() for r in refs)
    for (pname, _), v, r in zip(module.named_parameters(), values, refs):
        v = np.asarray(v, np.float64)
        scale = max(np.abs(r).max(), floor)
        np.testing.assert_allclose(v / scale, r / scale, rtol=0, atol=atol,
                                   err_msg=f'{name}.{pname}')


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(
            np.float32), tree)


# -------------------------------------------------------------- attention
def test_attention_backward_plain_matches_vmem_attention():
    """dq, dk, dv of the plain backward vs ``jax.vjp`` of the Pallas
    ``vmem_attention`` (interpret mode) at G=2, T=256, hd=32, for the
    upstream gradient cos(out) of sum(sin(out)): atol 5e-4, the JAX
    package's own bound (test_vmem_attention_fwd_bwd_parity)."""
    rng = np.random.RandomState(20)
    q, k, v = (rng.randn(2, 256, 32).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(32)
    out, vjp = jax.vjp(lambda q, k, v: vmem_attention(q, k, v, scale, True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g = np.cos(np.asarray(out))
    ref = vjp(jnp.asarray(g))
    o = tattn.attention(_t(q), _t(k), _t(v), scale)
    got = tattn.attention_backward(_t(q), _t(k), _t(v), o, None, _t(g),
                                   scale)
    for a, b, name in zip(got, ref, 'qkv'):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-4, err_msg=name)
        assert np.abs(np.asarray(b)).max() > 0.1


def test_self_attention_grads_match_flax():
    """Gradients of the UNet attention block (input and every parameter)
    through ``load_params`` vs the Flax module with the XLA core:
    max-normalised atol 1e-5 (f32 sums in another order)."""
    x = np.random.RandomState(21).randn(2, 16, 16, 128).astype(np.float32)
    jm = JSelfAttn(4, 1, 32, attn_kernel=False)
    params = _noisy(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                    np.random.RandomState(22), 0.05)
    w = np.random.RandomState(23).randn(*x.shape).astype(np.float32)
    gx_ref, gp_ref = jax.jit(jax.grad(
        lambda x, p: jnp.sum(jm.apply(p, x) * w), (0, 1)))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, params))
    tm = SelfAttention(128, 4, 32)
    load_params(tm, params)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    loss = (tm(xt).permute(0, 2, 3, 1) * _t(w)).sum()
    grads = torch.autograd.grad(loss, [xt] + list(tm.parameters()))
    _max_normalised(grads[0].permute(0, 2, 3, 1).numpy(), gx_ref, 'x', 1e-5)
    _compare_module(tm, [g.numpy() for g in grads[1:]], gp_ref,
                    'tm', 1e-5)


# ----------------------------------------------------------------- decode
def _decoder_pair(C=6, hidden=64, res=32, S=2, N=400, seed=30):
    jdec = JDecoder(base_layers=(3 * C, hidden), density_layers=(hidden, 1),
                    color_layers=(hidden, 3), dir_layers=(16, hidden),
                    compute_dtype='float32', backend='xla')
    rng = np.random.RandomState(seed)
    code = rng.randn(S, 3, C, res, res).astype(np.float32)
    xyz = rng.uniform(-1.05, 1.05, (S, N, 3)).astype(np.float32)
    dirs = rng.randn(S, N, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(code),
                       jnp.asarray(xyz), jnp.asarray(dirs))
    params = _noisy(params, rng, 0.1)
    tdec_ = TriPlaneDecoder(base_layers=(3 * C, hidden),
                            density_layers=(hidden, 1),
                            color_layers=(hidden, 3),
                            dir_layers=(16, hidden), compute_dtype='float32')
    load_params(tdec_, params)
    return jdec, params, tdec_, code, xyz, dirs


def test_decode_backward_plain_matches_xla_decoder_grads():
    """Gradients of a weighted sum of the activated density and colour,
    w.r.t. the codes and every decoder parameter, vs ``jax.grad`` through
    the f32 XLA decoder: max-normalised atol 1e-5."""
    jdec, params, tdec_, code, xyz, dirs = _decoder_pair()
    rng = np.random.RandomState(31)
    ws = rng.randn(*xyz.shape[:2]).astype(np.float32) * 1e-2
    wc = rng.randn(*xyz.shape).astype(np.float32)

    def jloss(code, p):
        s, c = jdec.apply(p, code, jnp.asarray(xyz), jnp.asarray(dirs))
        return jnp.sum(s * ws) + jnp.sum(c * wc)

    gc_ref, gp_ref = jax.jit(jax.grad(jloss, (0, 1)))(
        jnp.asarray(code), jax.tree_util.tree_map(jnp.asarray, params))
    ct = _t(code).requires_grad_()
    s, c = tdec_(ct, _t(xyz), _t(dirs))
    grads = torch.autograd.grad((s * _t(ws)).sum() + (c * _t(wc)).sum(),
                                [ct] + list(tdec_.parameters()))
    _max_normalised(grads[0].numpy(), gc_ref, 'code', 1e-5)
    _compare_module(tdec_, [g.numpy() for g in grads[1:]], gp_ref,
                    'tdec_', 1e-5)


def test_decode_backward_plain_matches_pallas_bwd():
    """Plane, dir_out and parameter gradients of the plain backward vs the
    Pallas kernel's backward (``_bwd`` in interpret mode) for random
    upstream gradients of the four raw outputs, res 128, S=2, R=16, K=64.
    The Pallas kernel rounds planes and weights to bf16, so the tolerance
    is the JAX package's own for that kernel vs its oracle
    (test_triplane_decode_grads_match_reference): max-normalised 4e-2."""
    rng = np.random.RandomState(32)
    S, R, K, res, C, hidden = 2, 16, 64, 128, 6, 64
    code = rng.randn(S, 3, C, res, res).astype(np.float32)
    x, y, z = (rng.uniform(-1, 1, (S, R, K)).astype(np.float32)
               for _ in range(3))
    dir_out = (rng.randn(S, R, hidden) * 0.3).astype(np.float32)
    wb = (rng.randn(3 * C, hidden) * 0.2).astype(np.float32)  # rows c*3+p
    bb = (rng.randn(hidden) * 0.1).astype(np.float32)
    wd = (rng.randn(hidden) * 0.3).astype(np.float32)
    wc = (rng.randn(3, hidden) * 0.3).astype(np.float32)
    bd, bc = np.float32(0.1), (rng.randn(3) * 0.1).astype(np.float32)
    g_outs = [rng.randn(S, R, K).astype(np.float32) for _ in range(4)]
    perm = [c * 3 + p for p in range(3) for c in range(C)]

    def padded(rows, n):
        a = np.zeros((128,) + rows.shape[1:], np.float32)
        a[:n] = rows
        return a

    bf = jnp.bfloat16
    jargs = (jnp.asarray(code.reshape(S, 3, C * res, res)),
             jnp.asarray(dir_out), jnp.asarray(wb[perm].T),
             jnp.asarray(bb[:, None]), jnp.asarray(padded(bd[None, None], 1)
                                                   .reshape(1, 128)),
             jnp.asarray(padded(bc[:, None], 3).reshape(1, 128)),
             jnp.asarray(padded(wd[None], 1)), jnp.asarray(padded(wc, 3)))

    def jloss(planes, dir_out, wf, bbt, b1, b2, w1t, w2t):
        outs = triplane_decode(
            planes.astype(bf), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(z), None, dir_out, wf.astype(bf), bbt, b1, b2,
            w1t.astype(bf), w2t.astype(bf), K, None, True)
        return sum(jnp.sum(o * g) for o, g in zip(outs, g_outs))

    gr = [np.asarray(a) for a in jax.grad(jloss, tuple(range(8)))(*jargs)]
    planes = _t(code).permute(0, 1, 3, 4, 2).contiguous()
    params = torch.cat([_t(wb.T).reshape(-1), _t(bb), _t(wd),
                        _t(wc).reshape(-1), torch.tensor([bd]), _t(bc)])
    xyz = torch.stack([_t(x), _t(y), _t(z)], -1).reshape(S, R * K, 3)
    rid = torch.arange(R, dtype=torch.int32).repeat_interleave(K).expand(
        S, R * K).contiguous()
    g_rgb = torch.stack([_t(g) for g in g_outs[1:]], -1).reshape(S, R * K, 3)
    d_planes, d_params, d_dir = tdec.triplane_decode_backward(
        planes, xyz, params, hidden, rid, _t(dir_out),
        _t(g_outs[0]).reshape(S, R * K), g_rgb)
    sizes = [hidden * 3 * C, hidden, hidden, 3 * hidden, 1, 3]
    d_wb, d_bb, d_wd, d_wc, d_bd, d_bc = (
        a.numpy() for a in torch.split(d_params, sizes))
    _max_normalised(d_planes.permute(0, 1, 4, 2, 3).reshape(
        S, 3, C * res, res).numpy(), gr[0], 'planes', 4e-2)
    _max_normalised(d_dir.numpy(), gr[1], 'dir_out', 4e-2)
    _max_normalised(d_wb.reshape(hidden, 3 * C)[:, perm], gr[2], 'W_base',
                    4e-2)
    _max_normalised(d_bb, gr[3][:, 0], 'b_base', 4e-2)
    _max_normalised(d_bd, gr[4][0, :1], 'b_density', 4e-2)
    _max_normalised(d_bc, gr[5][0, :3], 'b_colour', 4e-2)
    _max_normalised(d_wd, gr[6][0], 'W_density', 4e-2)
    _max_normalised(d_wc.reshape(3, hidden), gr[7][:3], 'W_colour', 4e-2)


# ----------------------------------------------------------------- render
def _scene(seed, S=2, n_rays=32, grid=64):
    """Codes, rays and a coherent occupancy (a ball plus noise voxels), as
    the JAX package's renderer tests build them."""
    rng = np.random.RandomState(seed)
    code = (0.5 * rng.randn(S, 3, 6, 128, 128)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing='ij'),
                      -1).reshape(-1, 3)
    r2 = ((coords - grid / 2 + 0.5) ** 2).sum(-1)
    occ = (r2 < (grid * 0.35) ** 2) | (rng.rand(grid ** 3) < 0.02)
    bitfield = _np(packbits(jnp.asarray(np.broadcast_to(
        occ.astype(np.float32), (S, grid ** 3)).copy()), 0.5))
    o = rng.randn(S, n_rays, 3).astype(np.float32) * 0.2
    o[..., 2] += 2.2
    d = -o + rng.randn(S, n_rays, 3).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return code, o, d, bitfield


def _render_decoders(seed=40, **torch_kwargs):
    jdec = JDecoder(backend='xla', compute_dtype='float32', compact_steps=64)
    params = jdec.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 6, 128, 128)),
                       jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    params = _noisy(params, np.random.RandomState(seed), 0.05)
    tdec_ = TriPlaneDecoder(compact_steps=64, compute_dtype='float32',
                            **torch_kwargs)
    load_params(tdec_, params)
    return jdec, params, tdec_


def _torch_render_grads(dec, code, o, d, bitfield, target, dt_gamma,
                        perturb=None):
    ct = _t(code).requires_grad_()
    out = volume_render(dec, ct, _t(o), _t(d), _t(bitfield), 64,
                        dt_gamma=dt_gamma, perturb=perturb)
    img = out['image'] + (1 - out['weights_sum'][..., None])
    loss = torch.mean((img - target) ** 2) * 1e3
    return torch.autograd.grad(loss, [ct] + list(dec.parameters()))


def test_render_grads_with_perturbation_match_jax():
    """``volume_render`` gradients w.r.t. the codes and every decoder
    parameter, with the start-t perturbation: the port gets JAX's own draw
    ``jax.random.uniform(perturb_key, (S, N))``.  Against JAX's XLA
    renderer with an f32 decoder, max-normalised atol 1e-4."""
    code, o, d, bitfield = _scene(seed=41)
    jdec, params, tdec_ = _render_decoders()
    dt_gamma = 0.004
    key = jax.random.PRNGKey(42)
    target = np.full((2, 32, 3), 0.3, np.float32)

    def jloss(code, p):
        out = jax_volume_render(jdec, p, code, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(bitfield), 64, dt_gamma=dt_gamma,
                                perturb_key=key)
        img = out['image'] + (1 - out['weights_sum'][..., None])
        return jnp.mean((img - target) ** 2) * 1e3

    gc_ref, gp_ref = jax.jit(jax.grad(jloss, (0, 1)))(
        jnp.asarray(code), jax.tree_util.tree_map(jnp.asarray, params))
    perturb = _t(jax.random.uniform(key, (2, 32)))
    grads = _torch_render_grads(tdec_, code, o, d, bitfield, _t(target),
                                dt_gamma, perturb)
    unperturbed = _torch_render_grads(tdec_, code, o, d, bitfield,
                                      _t(target), dt_gamma)
    assert not torch.allclose(grads[0], unperturbed[0], atol=1e-6)
    _max_normalised(grads[0].numpy(), gc_ref, 'code', 1e-4)
    _compare_module(tdec_, [g.numpy() for g in grads[1:]], gp_ref,
                    'tdec_', 1e-4)


def test_packed_render_grads_match_perray():
    """Port of tests/test_packing.py::test_packed_render_grads_match_perray:
    the packed layout (pack_slots 1024 = 16 rays x K, so nothing is
    truncated) against the per-ray layout, gradients w.r.t. codes and
    every decoder parameter, max-normalised atol 5e-2 as there; both reach
    the decode backward through ``rid``."""
    code, o, d, bitfield = _scene(seed=5, n_rays=64)
    _, _, perray = _render_decoders()
    packed = copy.deepcopy(perray)
    packed.pack_slots = 1024
    target = torch.full((2, 64, 3), 0.3)
    gx = _torch_render_grads(perray, code, o, d, bitfield, target, 0.0)
    gp = _torch_render_grads(packed, code, o, d, bitfield, target, 0.0)
    names = ['code'] + [n for n, _ in perray.named_parameters()]
    for a, b, name in zip(gp, gx, names):
        _max_normalised(a.numpy(), b.numpy(), name, 5e-2)
    assert gx[0].abs().max() > 0


# ------------------------------------------------------- diffusion + step
S, V, H, W = 2, 2, 16, 16
ESS, INTERVAL, N_RAYS = 3, 2, 128
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                 extra_scene_step=ESS, n_inverse_rays=N_RAYS,
                 n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
OPT_CFGS = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))
LR_CONFIG = dict(policy='step', warmup='linear', warmup_iters=2,
                 warmup_ratio=0.5, gamma=0.5, step=[1])


@pytest.fixture(scope='module')
def models():
    """The JAX model (XLA renderer, f32 decoder) with its optimizers, and
    the port (f32 decoder) with the same four weight trees (live and
    EMA): the JAX init plus seeded noise, so zero-initialised layers are
    live, and a density head that leaves part of each grid empty."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg['update_extra_interval'] = INTERVAL
    cfg['decoder']['compute_dtype'] = 'float32'
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder'].update(backend='xla')
    jm = jax_build_model(jcfg, train_cfg=TRAIN_CFG, test_cfg={})
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS, LR_CONFIG)
    state = jm.init_state(jax.random.PRNGKey(0), OPT_CFGS, schedules)
    rng = np.random.RandomState(50)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = tree[name]
    dens = tree['decoder']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, **jax.tree_util.tree_map(jnp.asarray, tree))
    tm = build_model(cfg, train_cfg=TRAIN_CFG, test_cfg={})
    load_jax_params(tm, tree)
    return jm, state, txs, tm


def test_forward_train_matches_jax(models):
    """``forward_train``'s loss, updated scale-norm factor and gradients
    w.r.t. the UNet parameters and the codes, with the timesteps and noise
    of JAX's own ``split(k_diff)``: loss rtol 1e-5, norm factor rtol 1e-6,
    gradients max-normalised atol 1e-4."""
    jm, state, _, tm = models
    rng = np.random.RandomState(51)
    x0 = rng.randn(S, 12, 16, 16).astype(np.float32)
    key = jax.random.PRNGKey(52)

    def jloss(p, x):
        loss, new_state, _ = jm.diffusion.forward_train(
            p, x, key, state['ddpm_loss'], update_norm=True)
        return loss, new_state

    (loss, norm), (gp_ref, gx_ref) = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(state['diffusion'], jnp.asarray(x0))
    t_key, n_key = jax.random.split(key)
    t = _t(jm.diffusion.timestep_sampler.sample(t_key, S)).long()
    noise = _t(jax.random.normal(n_key, x0.shape))
    diff = copy.deepcopy(tm.diffusion)
    xt = _t(x0).requires_grad_()
    tloss, logs = diff.forward_train(xt, t=t, noise=noise)
    grads = torch.autograd.grad(tloss, [xt] + list(diff.parameters()))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(diff.norm_factor.numpy(), np.asarray(norm),
                               rtol=1e-6)
    assert diff.norm_factor.item() != 1.0
    assert set(logs) >= {'loss_ddpm_mse', 'loss_mse_quartile_0'}
    _max_normalised(grads[0].numpy(), gx_ref, 'x_0', 1e-4)
    _compare_module(diff.denoising, [g.numpy() for g in grads[1:]], gp_ref,
                    'unet', 1e-4)


def _jax_step_draws(jm, key, P, S=S, ess=ESS, interval=INTERVAL,
                    n_rays=N_RAYS):
    """Every draw of JAX's ``train_step`` and its ``inverse_code``, key
    split for key split, as the port's ``train_draws`` dict: ``S`` scenes
    of ``P`` pixels, ``ess`` inner steps with a density refresh every
    ``interval``, ``n_rays`` rays for the inner and the decoder steps."""
    (_, _, k_diff, _, k_inv, k_upd, k_ray, k_pert) = jax.random.split(key, 8)
    t_key, n_key = jax.random.split(k_diff)
    Hg = jm.grid_size
    half = jm.decoder.bound / Hg

    def jitter(k):
        return _t(jax.random.uniform(k, (Hg ** 3, 3), minval=-half,
                                     maxval=half))

    k, bkey = jax.random.split(k_inv)
    ray_inds = make_raybatch_indices(bkey, S, P, n_rays, ess)
    inner_jitter, inner_perturb = [], []
    for i in range(ess):
        k, ukey, _, pkey, _ = jax.random.split(k, 5)
        if i % interval == 0:
            inner_jitter.append(jitter(ukey))
        inner_perturb.append(_t(jax.random.uniform(pkey, (S, n_rays))))
    keys = jax.random.split(k_ray, S)
    dec_inds = jax.vmap(lambda kk: jax.random.permutation(kk, P)[:n_rays])(
        keys)
    return dict(
        t=_t(jm.diffusion.timestep_sampler.sample(t_key, S)).long(),
        noise=_t(jax.random.normal(n_key, (S,) + tuple(jm.code_reshape))),
        inverse=dict(ray_inds=_t(ray_inds).long(),
                     jitter=torch.stack(inner_jitter),
                     perturb=torch.stack(inner_perturb)),
        jitter=jitter(k_upd), ray_inds=_t(dec_inds).long(),
        perturb=_t(jax.random.uniform(k_pert, (S, n_rays))))


def _jax_adam_moments(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, 'mu'))
    s = next(s for s in leaves if hasattr(s, 'mu'))
    return s.mu, s.nu


def _compare_moments(module, optimizer, jax_opt_state, name, atol):
    """The torch optimizer's Adam moments vs optax's, parameter by
    parameter (optax's trees are read into a copy of the module)."""
    for key, tree in zip(('exp_avg', 'exp_avg_sq'),
                         _jax_adam_moments(jax_opt_state)):
        _compare_module(module, [optimizer.state[p][key].numpy()
                                 for p in module.parameters()], tree,
                        f'{name} {key}', atol)


def test_train_step_matches_jax(models):
    """Two consecutive ``train_step``s vs JAX's ``DiffusionNeRF.train_step``
    on the same weights, scenes and replayed draws (timesteps, noise, the
    inner loop's ray batches, density jitters and perturbations, the
    decoder step's ray sample and perturbation), ``extra_scene_step`` 3
    with a density refresh at inner steps 0 and 2.

    Adam turns the first gradient of every parameter into +-lr, so the
    comparison is made on the gradients, through the optimizers' moments
    (m and v of the codes, the UNet and the decoder, max-normalised atol
    2e-3 after f32 sums in another order through four chained renders);
    the updated codes and the decoder and UNet weights are compared at
    atol 1e-5, a thousandth of the largest Adam step.  Losses rtol 1e-4,
    scale-norm factor rtol 1e-6, the bitfields equal and the step counters
    exactly.  The f16 density grid: rtol 5e-3, since densities are exp of
    raw outputs, and the codes' 1e-5 differences reach them through the
    tenfold density head as up to 2e-3 relative."""
    jm, state, txs, tm = models
    tm = copy.deepcopy(tm)
    data_np = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=5)
    data_np = {k: data_np[k] for k in
               ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    code0 = (np.random.RandomState(53).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    tdata = {k: _t(v) for k, v in data_np.items()}
    jdata = {k: jnp.asarray(v) for k, v in data_np.items()}
    opts, scheds = build_optimizers(tm, OPT_CFGS, LR_CONFIG)
    step = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))
    key = jax.random.PRNGKey(54)
    for i in range(2):
        key, sub = jax.random.split(key)
        draws = _jax_step_draws(jm, sub, V * H * W)
        state, jbatch, jlogs = step(state, jbatch, jdata, sub)
        tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds,
                                      draws=draws)
        for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                     'reg_loss', 'loss_mse_quartile_0', 'train_psnr'):
            np.testing.assert_allclose(
                np.asarray(tlogs[name]), np.asarray(jlogs[name]), rtol=1e-4,
                err_msg=f'step {i}: {name}')
        np.testing.assert_allclose(tm.diffusion.norm_factor.numpy(),
                                   np.asarray(state['ddpm_loss']), rtol=1e-6)
        jopt, topt = jbatch['opt'], tbatch['opt']
        np.testing.assert_array_equal(topt.step.numpy(), np.asarray(
            jopt.step))
        assert int(topt.step[0]) == (i + 1) * (ESS + 1)
        _max_normalised(topt.m.numpy(), jopt.m, f'step {i}: code m', 2e-3)
        _max_normalised(topt.v.numpy(), jopt.v, f'step {i}: code v', 2e-3)
        np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            tbatch['density_grid'].float().numpy(),
            np.asarray(jbatch['density_grid'], np.float32), rtol=5e-3,
            atol=1e-4)
        np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                      np.asarray(jbatch['density_bitfield']))
        bits = np.unpackbits(tbatch['density_bitfield'].numpy()).mean()
        assert 0.02 < bits < 0.98, bits
        _compare_moments(tm.decoder, opts['decoder'], state['opt_decoder'],
                         f'step {i}: decoder', 2e-3)
        _compare_moments(tm.diffusion.denoising, opts['diffusion'],
                         state['opt_diffusion'], f'step {i}: unet', 2e-3)
        for module, name in ((tm.decoder, 'decoder'),
                             (tm.diffusion.denoising, 'diffusion')):
            ref = copy.deepcopy(module)
            load_params(ref, jax.tree_util.tree_map(_np, state[name]))
            for (pname, p), r in zip(module.named_parameters(),
                                     ref.parameters()):
                np.testing.assert_allclose(
                    p.detach().numpy(), r.detach().numpy(), rtol=0,
                    atol=1e-5, err_msg=f'step {i}: {name}.{pname}')
    # after two updates: one step milestone passed, warmup over
    assert opts['decoder'].param_groups[0]['lr'] == pytest.approx(0.5e-3)


def test_train_step_freeze_norm_matches_jax(models):
    """``freeze_norm`` (a model attribute, as in JAX, which the runner's
    ModelUpdaterHook sets): one ``train_step`` with it on against JAX's on
    the same weights and replayed draws leaves the scale-norm factor where
    it was on both sides, with the losses (rtol 1e-4) and the codes' Adam
    moments (max-normalised 2e-3) of JAX's.  With PyTorch's TF32 switches
    on, the UNet's backward still runs with them off (read when the
    gradient reaches the UNet's output)."""
    jm, state, txs, tm = models
    tm = copy.deepcopy(tm)
    assert tm.freeze_norm is False
    tm.freeze_norm = True
    data_np = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=55)
    data_np = {k: data_np[k] for k in
               ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    code0 = (np.random.RandomState(56).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    key = jax.random.PRNGKey(57)
    jm.freeze_norm = True
    try:
        new_state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
            s, b, d, k, txs['diffusion'], txs['decoder']))(
            state, jbatch, {k: jnp.asarray(v) for k, v in data_np.items()},
            key)
    finally:
        jm.freeze_norm = False
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = []

    def on_output(module, inputs, out):
        out.register_hook(
            lambda g: flags.append((cudnn.allow_tf32, mm.allow_tf32)))

    tm.diffusion.denoising.register_forward_hook(on_output)
    norm0 = tm.diffusion.norm_factor.clone()
    opts, scheds = build_optimizers(tm, OPT_CFGS, LR_CONFIG)
    saved = cudnn.allow_tf32, mm.allow_tf32
    try:
        cudnn.allow_tf32 = mm.allow_tf32 = True
        tbatch, tlogs = tm.train_step(
            tbatch, {k: _t(v) for k, v in data_np.items()}, opts, scheds,
            draws=_jax_step_draws(jm, key, V * H * W))
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved
    assert flags == [(False, False)]
    assert torch.equal(tm.diffusion.norm_factor, norm0)
    np.testing.assert_array_equal(np.asarray(new_state['ddpm_loss']),
                                  np.asarray(state['ddpm_loss']))
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss'):
        np.testing.assert_allclose(np.asarray(tlogs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-4,
                                   err_msg=name)
    _max_normalised(tbatch['opt'].m.numpy(), jbatch['opt'].m, 'code m', 2e-3)


def test_load_jax_params_fills_live_and_ema_trees(models):
    """``load_jax_params`` fills each of the four modules from its own
    tree (live and EMA weights differ here), and raises on a missing or
    misshapen leaf, on a tree the model keeps no module for, and on a
    state with none of the four trees."""
    jm, state, _, _ = models
    tree = {name: jax.tree_util.tree_map(_np, state[name]) for name in
            ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema')}
    tree['decoder_ema'] = _noisy(tree['decoder_ema'],
                                 np.random.RandomState(60), 0.1)
    tree['diffusion_ema'] = _noisy(tree['diffusion_ema'],
                                   np.random.RandomState(61), 0.1)
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    tm = load_jax_params(build_model(copy.deepcopy(cfg)), tree)
    for name, module in (('decoder', tm.decoder),
                         ('decoder_ema', tm.decoder_ema),
                         ('diffusion', tm.diffusion.denoising),
                         ('diffusion_ema', tm.diffusion_ema.denoising)):
        _compare_module(module, [p.detach().numpy()
                                 for p in module.parameters()],
                        tree[name], name, 0.0)
    assert not torch.equal(tm.decoder.base_net.dense_0.weight,
                           tm.decoder_ema.base_net.dense_0.weight)

    broken = copy.deepcopy(tree)
    del broken['diffusion_ema']['params']['out_conv']
    with pytest.raises(KeyError):
        load_jax_params(build_model(copy.deepcopy(cfg)), broken)
    broken = copy.deepcopy(tree)
    broken['decoder']['params']['base_net']['dense_0']['kernel'] = \
        np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(build_model(copy.deepcopy(cfg)), broken)
    with pytest.raises(KeyError):
        load_jax_params(build_model(dict(cfg, decoder_use_ema=False)),
                        {'decoder_ema': tree['decoder_ema']})
    with pytest.raises(KeyError):
        load_jax_params(build_model(copy.deepcopy(cfg)), {'params': {}})


def test_device_scene_cache_round_trip(models):
    """The scene bank: ``ensure_init`` writes fresh codes (uniform in
    +-init_scale) into unseen rows only, ``load`` gives copies of a batch's
    rows, ``save`` writes them back, and ids outside the bank raise."""
    tm = models[3]
    bank = tm.make_cache('cpu')
    assert bank.code_.shape == (tm.cache_size,) + tm.code_size
    g = torch.Generator().manual_seed(62)
    batch = bank.load([3, 1], lambda n: tm.get_init_code(n, g))
    assert 0 < batch['code_'].abs().max() <= tm.init_scale
    assert bank.code_[[0, 2]].abs().max() == 0
    batch['code_'] += 1.0                      # a copy, not the bank
    assert bank.code_.abs().max() <= tm.init_scale
    opt = adam_init(batch['code_'])
    opt.step[:] = 5
    bank.save([3, 1], batch['code_'], opt, batch['density_grid'] + 1,
              batch['density_bitfield'] + 7)
    again = bank.load([1, 3], lambda n: tm.get_init_code(n, g))
    torch.testing.assert_close(again['code_'], batch['code_'].flip(0))
    assert again['opt'].step.tolist() == [5, 5]
    assert (again['density_bitfield'] == 7).all()
    assert bank.seen.tolist() == [False, True, False, True]
    with pytest.raises(IndexError):
        bank.load([4])


def test_weight_decay_raises(models):
    """A code weight decay no longer raises: the train step's code Adam
    reads it from ``train_cfg['optimizer']`` and adds ``weight_decay *
    code_`` to the gradient before the moments, as JAX's ``adam_step``
    (whole steps against JAX's in ``test_torch_options_rest.py``).  For
    the networks a weight decay builds ``torch.optim.AdamW``
    (``optax.adamw``, as JAX's ``make_optimizer`` does; its update is held
    in ``test_torch_runner.py``)."""
    tm = models[3]
    assert code_adam_cfg(dict(type='Adam', lr=1e-2, weight_decay=1e-4)) \
        == (1e-2, (0.9, 0.999), 1e-4)
    assert code_adam_cfg(tm.train_cfg['optimizer'])[2] == 0.0
    g = torch.Generator().manual_seed(0)
    code_ = torch.randn((2, 3, 4), generator=g)
    grad = torch.randn((2, 3, 4), generator=g)
    got = adam_step(code_, grad, adam_init(code_), 1e-2, weight_decay=1e-4)
    ref = adam_step(code_, grad + 1e-4 * code_, adam_init(code_), 1e-2)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].m, ref[1].m, rtol=0, atol=0)
    opts, _ = build_optimizers(tm, dict(decoder=dict(type='Adam', lr=1e-3,
                                                     weight_decay=1e-4)))
    assert isinstance(opts['decoder'], torch.optim.AdamW)
    assert opts['decoder'].defaults['weight_decay'] == 1e-4


def test_train_step_bf16_decode_matches_jax_pallas(models):
    """One ``train_step`` with the decoders' default ``compute_dtype``
    (bf16) on both sides: JAX's renderer on its Pallas kernels and their
    custom VJP in interpret mode (``backend='pallas-interpret'``, a 64^3
    grid, which its Pallas march needs) and the port's bf16 decode and
    backward, the same weights, scenes and replayed draws as
    :func:`test_train_step_matches_jax`.  Losses rtol 1e-4 and the codes'
    and the UNet's Adam moments max-normalised 2e-3, as there; the
    decoder's moments 2^-6 (its weights' gradients are rounded to bf16,
    one ulp 2^-7 relative, two for the squares); the f16 density grid:
    all but 0.5% of the voxels within rtol 5e-3 (as there), every one
    within 5% (a rounding to bf16 that falls the other way, carried
    through the tenfold density head and exp); at most 0.1% of the bits
    flipped."""
    jm0, state, txs, _ = models
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg.update(update_extra_interval=INTERVAL, grid_size=64)
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder']['backend'] = 'pallas-interpret'
    jm = jax_build_model(jcfg, train_cfg=TRAIN_CFG, test_cfg={})
    tm = build_model(cfg, train_cfg=TRAIN_CFG, test_cfg={})
    load_jax_params(tm, {k: jax.tree_util.tree_map(_np, state[k]) for k in
                         ('decoder', 'decoder_ema', 'diffusion',
                          'diffusion_ema')})
    assert tm.decoder.compute_dtype == 'bfloat16'
    data_np = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=5)
    data_np = {k: data_np[k] for k in
               ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    code0 = (np.random.RandomState(53).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    opts, scheds = build_optimizers(tm, OPT_CFGS, LR_CONFIG)
    key = jax.random.PRNGKey(58)
    new_state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(
        state, jbatch, {k: jnp.asarray(v) for k, v in data_np.items()}, key)
    tbatch, tlogs = tm.train_step(
        tbatch, {k: _t(v) for k, v in data_np.items()}, opts, scheds,
        draws=_jax_step_draws(jm, key, V * H * W))
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'reg_loss'):
        np.testing.assert_allclose(np.asarray(tlogs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-4,
                                   err_msg=name)
    _max_normalised(tbatch['opt'].m.numpy(), jbatch['opt'].m, 'code m', 2e-3)
    _max_normalised(tbatch['opt'].v.numpy(), jbatch['opt'].v, 'code v', 2e-3)
    g = tbatch['density_grid'].float().numpy()
    jg = np.asarray(jbatch['density_grid'], np.float32)
    err = np.abs(g - jg)
    assert (err > 5e-3 * np.abs(jg) + 1e-4).mean() <= 5e-3
    assert (err <= 0.05 * np.abs(jg) + 1e-4).all()
    bits = np.unpackbits(np.asarray(jbatch['density_bitfield']))
    assert 0.02 < bits.mean() < 0.98, bits.mean()
    assert (np.unpackbits(tbatch['density_bitfield'].numpy())
            != bits).mean() <= 1e-3
    _compare_moments(tm.decoder, opts['decoder'], new_state['opt_decoder'],
                     'decoder', 2.0 ** -6)
    _compare_moments(tm.diffusion.denoising, opts['diffusion'],
                     new_state['opt_diffusion'], 'unet', 2e-3)
