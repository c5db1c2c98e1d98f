"""The port's data parallelism on two CPU ranks (gloo), against one process
and against the JAX package's single-device step on the global batch.

One module fixture runs ``tests/torch_parallel_worker.py`` as two ranks
(each group with a 60 s timeout, each process joined with a timeout): two
``DiffusionNeRF.train_step``s of 8 scenes as 4 + 4, two stage-1 steps in
two variants, ``sharded_volume_render``, ``evaluate_3d`` with the batches
shared out and the weighted-sum gather.  The JAX step and render run
here.  Tolerances: against one process 1e-5
relative (arrays max-normalised); against JAX those of
``tests/test_torch_train.py::test_train_step_matches_jax``.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_train import (INTERVAL, LR_CONFIG, OPT_CFGS, TRAIN_CFG,
                              _jax_step_draws, _max_normalised, _noisy, _np,
                              _t)
from test_torch_eval import _write_srn
from test_torch_stage1 import stage1_cfg
from torch_parallel_worker import evaluate, train_steps
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_tpu.models.autodecoders.multiscene import (
    DeviceSceneCache as JaxDeviceCache, SceneCache as JaxHostCache)
from ssdnerf_tpu.models.decoders.renderer import volume_render as jax_render
from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDecoder
from ssdnerf_tpu.ops import packbits
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import load_jax_params, load_params
from ssdnerf_torch.models.autodecoders.multiscene import (DeviceSceneCache,
                                                          HostSceneCache,
                                                          build_decoder)
from ssdnerf_torch.parallel import shard_bounds
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.train import free_port

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
S, V, H, W = 8, 2, 16, 16        # the global batch: 4 + 4 scenes
WORLD = 2
WORKER_TIMEOUT = 240


def start_ranks(job, tmp, world=WORLD):
    """``job`` started in ``world`` worker ranks; :func:`finish_ranks`
    collects their results."""
    job_path = str(tmp / 'job.pt')
    torch.save(job, job_path)
    port = free_port()
    outs = [str(tmp / f'out{r}.pt') for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS='2')
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_parallel_worker.py'),
         str(r), str(world), str(port), job_path, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    return procs, outs


def finish_ranks(procs, outs):
    """The started ranks' results, in rank order (each process joined with
    a timeout, killed past it); a rank that failed fails the test."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(
                errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} failed:\n{log[-4000:]}'
    return [torch.load(o, weights_only=False) for o in outs]


def cat_ranks(results, key):
    """The ranks' scene batches joined along the scene axis."""
    return {k: torch.cat([r['steps'][key]['batch'][k] for r in results])
            for k in results[0]['steps'][key]['batch']}


def rel(a, b, what, tol=1e-5):
    """Max-normalised: |a - b| <= tol * max|b|."""
    _max_normalised(np.asarray(a, np.float64), np.asarray(b, np.float64),
                    what, tol)


def diffusion_cfg(**over):
    """TINY_MODEL_CFG with an f32 decoder, and the model keys ``over``."""
    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), **over)
    cfg['update_extra_interval'] = INTERVAL
    cfg['decoder']['compute_dtype'] = 'float32'
    return cfg


def diffusion_pair(model=None, train_cfg=TRAIN_CFG):
    """The JAX model with its state and optimizers, and the port's spec
    with the same weights (``test_torch_train``'s models: f32 decoders,
    the JAX init plus seeded noise, a density head that leaves part of
    each grid empty); ``model``: keys over the tiny model's config."""
    cfg = diffusion_cfg(**(model or {}))
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder'].update(backend='xla')
    jm = jax_build_model(jcfg, train_cfg=train_cfg, test_cfg={})
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS, LR_CONFIG)
    # one jit: eager, the Flax init compiles each op (~30 s)
    state = dict(jax.jit(lambda k: jm.init_state(k, OPT_CFGS, schedules))(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(50)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = tree[name]
    dens = tree['decoder']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, **jax.tree_util.tree_map(jnp.asarray, tree))
    tm = build_model(cfg, train_cfg=train_cfg, test_cfg={})
    load_jax_params(tm, tree)

    data_np = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=5)
    data_np = {k: data_np[k] for k in
               ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    code0 = (np.random.RandomState(53).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    H3 = jm.grid_size ** 3
    key = jax.random.PRNGKey(54)
    keys, draws = [], []
    for _ in range(2):
        key, sub = jax.random.split(key)
        keys.append(sub)
        draws.append(_jax_step_draws(jm, sub, V * H * W, S=S))
    spec = dict(cfg=cfg, train_cfg=train_cfg, state=tm.state_dict(),
                opt_cfgs=OPT_CFGS, lr_config=LR_CONFIG, draws=draws,
                scene_batch=dict(
                    code_=_t(code0), m=torch.zeros(code0.shape),
                    v=torch.zeros(code0.shape),
                    step=torch.zeros(S, dtype=torch.int32),
                    density_grid=torch.zeros((S, H3), dtype=torch.float16),
                    density_bitfield=torch.zeros((S, H3 // 8),
                                                 dtype=torch.uint8)),
                data={k: _t(v) for k, v in data_np.items()})
    jax_side = dict(jm=jm, state=state, txs=txs, keys=keys, code0=code0,
                    data=data_np)
    return spec, jax_side


STAGE1 = dict(
    # the activation's running statistics (from a state far off the codes')
    normalized=dict(act='normalized', over={}),
    # the mean code's EMA (NormalizedTanhCode cannot take it: ROADMAP
    # section 3 item 13)
    mean=dict(act='tanh', over=dict(init_from_mean=True,
                                    mean_ema_momentum=0.3)),
)
S1_TRAIN = dict(TRAIN_CFG, extra_scene_step=2)
S1_OPT = dict(decoder=OPT_CFGS['decoder'])


def stage1_spec(name, seed=70):
    """A stage-1 model spec of variant ``name`` with seeded weights and the
    port's own draws of two global 8-scene steps."""
    cfg = stage1_cfg(STAGE1[name]['act'], **STAGE1[name]['over'])
    tm = build_model(cfg, train_cfg=S1_TRAIN, test_cfg={})
    gen = torch.Generator().manual_seed(seed)
    tm.init_weights(gen)
    tm.reset_ema()
    if tm.code_act is not None:
        tm.code_act = (torch.full((1,), 0.2), torch.full((1,), 0.05))
    if tm.init_code is not None:
        tm.init_code = 0.1 * torch.randn(tm.code_size, generator=gen)
    P = V * H * W
    draws = [tm.train_draws(S, P, gen) for _ in range(2)]
    data_np = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=7)
    code0 = 0.5 * torch.randn((S,) + tm.code_size, generator=gen)
    H3 = tm.grid_size ** 3
    return dict(cfg=cfg, train_cfg=S1_TRAIN, state=tm.state_dict(),
                opt_cfgs=S1_OPT, lr_config=LR_CONFIG, draws=draws,
                scene_batch=dict(
                    code_=code0, m=torch.zeros_like(code0),
                    v=torch.zeros_like(code0),
                    step=torch.zeros(S, dtype=torch.int32),
                    density_grid=torch.zeros((S, H3), dtype=torch.float16),
                    density_bitfield=torch.zeros((S, H3 // 8),
                                                 dtype=torch.uint8)),
                data={k: _t(data_np[k]) for k in
                      ('cond_imgs', 'cond_poses', 'cond_intrinsics')})


def render_inputs():
    """JAX's sharded-render test inputs (``tests/test_parallel.py``): 2
    scenes x 256 rays, 3x6x128^2 codes, a 64^3 grid at 30% occupancy; an
    f32 decoder with JAX's init."""
    rng = np.random.RandomState(0)
    Sr, N, grid = 2, 256, 64
    code = 0.3 * rng.randn(Sr, 3, 6, 128, 128).astype(np.float32)
    occ = (rng.rand(Sr, grid ** 3) < 0.3).astype(np.float32)
    bitfield = np.asarray(packbits(jnp.asarray(occ), 0.5))
    o = rng.randn(Sr, N, 3).astype(np.float32) * 0.2
    o[..., 2] += 2.2
    d = -o + rng.randn(Sr, N, 3).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jdec = JDecoder(compute_dtype='float32', backend='xla')
    params = jax.jit(jdec.init)(jax.random.PRNGKey(1),
                                jnp.asarray(code[:1]), jnp.zeros((1, 8, 3)),
                                jnp.zeros((1, 8, 3)))
    dec_cfg = dict(compute_dtype='float32')
    tdec = build_decoder(dec_cfg)
    load_params(tdec, jax.tree_util.tree_map(_np, params))
    return dict(jdec=jdec, params=params, code=code, bitfield=bitfield,
                o=o, d=d, grid=grid), dict(
        decoder_cfg=dec_cfg, decoder_state=tdec.state_dict(),
        code=_t(code), rays_o=_t(o), rays_d=_t(d), bitfield=_t(bitfield),
        grid_size=grid)


EVAL_SCENES, EVAL_VIEWS = 5, 2


def eval_inputs(spec, srn):
    """:func:`torch_parallel_worker.evaluate`'s spec: the diffusion
    model of ``spec`` generating unconditionally (4 DDIM steps, one code
    polish step) on 5 SRN scenes of 2 test views, in batches of 2 (3
    batches, the last padded: 2 for rank 0, 1 for rank 1) and of 8 (one
    batch, rank 1 evaluating none)."""
    _write_srn(srn, num_scenes=EVAL_SCENES, num_views=EVAL_VIEWS)
    return dict(
        cfg=spec['cfg'], state=spec['state'], srn=srn,
        test_cfg=dict(img_size=(H, W), num_timesteps=4, clip_range=[-2, 2],
                      density_thresh=0.1, density_step=2, n_inverse_steps=1,
                      optimizer=dict(type='Adam', lr=0.005),
                      lr_scheduler=dict(type='ExponentialLR', gamma=0.9)),
        dataset=dict(load_imgs=False, num_test_imgs=EVAL_VIEWS,
                     scene_id_as_name=True),
        batch_sizes=[2, 8], num_images=EVAL_SCENES * EVAL_VIEWS,
        draw_seed=300)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two ranks' results; while they run, the one-process steps, and
    JAX's two 8-scene steps and its render."""
    spec, jx = diffusion_pair()
    render_jax, render_job = render_inputs()
    steps = dict(diffusion=spec,
                 **{f'stage1_{n}': stage1_spec(n) for n in STAGE1})
    tmp = tmp_path_factory.mktemp('ranks')
    eval_spec = eval_inputs(spec, str(tmp / 'srn'))
    started = start_ranks(dict(steps=steps, render=render_job,
                               eval=eval_spec), tmp)
    single = {name: train_steps(s) for name, s in steps.items()}
    single_eval = evaluate(eval_spec)
    state, jbatch, jlogs = jax_steps(jx)
    r = render_jax
    jrender = jax.jit(lambda p, c, o, d, b: jax_render(
        r['jdec'], p, c, o, d, b, r['grid']))(
        r['params'], jnp.asarray(r['code']), jnp.asarray(r['o']),
        jnp.asarray(r['d']), jnp.asarray(r['bitfield']))
    return dict(results=finish_ranks(*started), single=single, specs=steps,
                single_eval=single_eval,
                jax=dict(state=state, batch=jbatch, logs=jlogs,
                         render=jrender))


def jax_steps(jx):
    """JAX's two 8-scene steps of :func:`diffusion_pair`'s JAX side: its
    state, scene batch and last log vars."""
    jm, state, txs = jx['jm'], jx['state'], jx['txs']
    code0 = jnp.asarray(jx['code0'])
    jbatch = dict(code_=code0, opt=jax_adam_init(code0),
                  density_grid=jnp.zeros((S, jm.grid_size ** 3),
                                         jnp.float16),
                  density_bitfield=jnp.zeros((S, jm.grid_size ** 3 // 8),
                                             jnp.uint8))
    jdata = {k: jnp.asarray(v) for k, v in jx['data'].items()}
    step = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))
    for sub in jx['keys']:
        state, jbatch, jlogs = step(state, jbatch, jdata, sub)
    return state, jbatch, jlogs


def check_against_single(results, single, key):
    """Two ranks vs one process: log vars rtol 1e-5; the scene batch 1e-5
    max-normalised, step counters and bitfields exactly; the weights and
    buffers, and the optimizers' moments, 1e-5 of the largest entry of
    their module (a gradient that is zero in exact arithmetic, as a conv
    bias before a one-channel GroupNorm's, is rounding noise that Adam
    turns into steps, so no tensor is scaled by itself alone); both ranks'
    log vars, weights and moments bitwise equal."""
    got = cat_ranks(results, key)
    ref = single[key]
    for i, (a, b) in enumerate(zip(results[0]['steps'][key]['logs'],
                                   ref['logs'])):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                       err_msg=f'{key} step {i}: {k}')
        other = results[1]['steps'][key]['logs'][i]
        np.testing.assert_array_equal([a[k] for k in b],
                                      [other[k] for k in b])
    for k in ('code_', 'm', 'v'):
        rel(got[k].numpy(), ref['batch'][k].numpy(), f'{key}: {k}')
    rel(got['density_grid'].float().numpy(),
        ref['batch']['density_grid'].float().numpy(), f'{key}: grid')
    for k in ('step', 'density_bitfield'):
        assert torch.equal(got[k], ref['batch'][k]), k
    s0, s1 = (r['steps'][key]['state'] for r in results)
    module_max = {}
    for name, t in ref['state'].items():
        m = name.split('.')[0]
        module_max[m] = max(module_max.get(m, 0.0), float(t.abs().max()))
    for name, t in ref['state'].items():
        assert torch.equal(s0[name], s1[name]), f'ranks differ: {name}'
        scale = module_max[name.split('.')[0]] or 1.0
        np.testing.assert_allclose(s0[name].double().numpy() / scale,
                                   t.double().numpy() / scale, rtol=0,
                                   atol=1e-5, err_msg=f'{key}: {name}')
    for opt in ref['optimizers']:
        o0, o1 = (r['steps'][key]['optimizers'][opt]['state']
                  for r in results)
        st = ref['optimizers'][opt]['state']
        for m in ('exp_avg', 'exp_avg_sq'):
            scale = max(float(v[m].abs().max()) for v in st.values())
            for pid, v in st.items():
                assert torch.equal(o0[pid][m], o1[pid][m])
                np.testing.assert_allclose(
                    o0[pid][m].double().numpy() / scale,
                    v[m].double().numpy() / scale, rtol=0, atol=1e-5,
                    err_msg=f'{key}: {opt} {pid} {m}')


def test_diffusion_step_two_ranks_match_one_process(runs):
    """Two 4-scene ranks take the 8-scene step of one process."""
    check_against_single(runs['results'], runs['single'], 'diffusion')


def test_diffusion_step_two_ranks_match_jax_global_batch(runs):
    """The ranks' two steps against JAX's single-device ``train_step`` on
    all 8 scenes with the same draws, within the bounds of
    ``test_torch_train.py::test_train_step_matches_jax``: losses rtol
    1e-4, scale-norm factor rtol 1e-6, codes atol 1e-5 (or within 1e-6 of
    the one-process port's own error, where that is larger), code moments
    2e-3 max-normalised, f16 grids rtol 5e-3, bitfields and step counters
    exactly, network weights atol 1e-5."""
    check_against_jax(runs['results'], runs['single'], runs['jax'],
                      'diffusion', runs['specs']['diffusion'])


def check_against_jax(results, single, jax_out, key, spec):
    """The ranks' steps of ``spec``, named ``key`` (from
    :func:`diffusion_pair`), against ``jax_out``, JAX's
    (:func:`jax_steps`), at the bounds of
    ``test_diffusion_step_two_ranks_match_jax_global_batch``."""
    state, jbatch, jlogs = (jax_out[k] for k in ('state', 'batch', 'logs'))
    logs = results[0]['steps'][key]['logs'][-1]
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'reg_loss',
                 'loss_mse_quartile_0', 'train_psnr'):
        np.testing.assert_allclose(logs[name], float(jlogs[name]),
                                   rtol=1e-4, err_msg=name)
    got = cat_ranks(results, key)
    tstate = results[0]['steps'][key]['state']
    np.testing.assert_allclose(tstate['diffusion.norm_factor'].numpy(),
                               np.asarray(state['ddpm_loss']), rtol=1e-6)
    jopt = jbatch['opt']
    np.testing.assert_array_equal(got['step'].numpy(), np.asarray(jopt.step))
    _max_normalised(got['m'].numpy(), jopt.m, 'code m', 2e-3)
    _max_normalised(got['v'].numpy(), jopt.v, 'code v', 2e-3)
    # the codes: atol 1e-5, or where the one-process port's own 8-scene
    # step is further from JAX (Adam's steps amplify the f32 noise of small
    # gradients: 2.7e-5 at 3 of 24576 elements), within 1e-6 of its error
    jc = np.asarray(jbatch['code_'])
    err_one = np.abs(single[key]['batch']['code_'].numpy() - jc)
    err_two = np.abs(got['code_'].numpy() - jc)
    assert np.all(err_two <= np.maximum(1e-5, err_one + 1e-6)), \
        float(np.max(err_two - np.maximum(1e-5, err_one + 1e-6)))
    np.testing.assert_allclose(
        got['density_grid'].float().numpy(),
        np.asarray(jbatch['density_grid'], np.float32), rtol=5e-3,
        atol=1e-4)
    np.testing.assert_array_equal(got['density_bitfield'].numpy(),
                                  np.asarray(jbatch['density_bitfield']))
    tm = build_model(spec['cfg'], train_cfg=spec['train_cfg'], test_cfg={})
    tm.load_state_dict(tstate)
    for module, name in ((tm.decoder, 'decoder'),
                         (tm.diffusion.denoising, 'diffusion')):
        ref = copy.deepcopy(module)
        load_params(ref, jax.tree_util.tree_map(_np, state[name]))
        for (pname, p), r in zip(module.named_parameters(),
                                 ref.parameters()):
            np.testing.assert_allclose(
                p.detach().numpy(), r.detach().numpy(), rtol=0, atol=1e-5,
                err_msg=f'{name}.{pname}')


@pytest.mark.parametrize('variant', list(STAGE1))
def test_stage1_step_two_ranks_match_one_process(runs, variant):
    """Stage-1 steps on 4 + 4 scenes vs one process on 8: with
    NormalizedTanhCode the running mean and variance come from every
    rank's codes; with ``init_from_mean`` the mean code's EMA does."""
    key = f'stage1_{variant}'
    check_against_single(runs['results'], runs['single'], key)
    state = runs['results'][0]['steps'][key]['state']
    start = stage1_spec(variant)['state']
    moved = [n for n in ('code_act_0', 'code_act_1', 'init_code')
             if n in state]
    assert moved
    for n in moved:
        assert not torch.equal(state[n], start[n]), n


def test_sharded_volume_render_matches_jax(runs):
    """Each rank renders 128 of the 256 rays of each scene; the gathered
    outputs on both ranks vs JAX's ``volume_render`` of all of them (f32
    decoders): atol 1e-4, as the port's render parity tests."""
    ref = runs['jax']['render']
    out0, out1 = (res['render'] for res in runs['results'])
    for k in ('weights_sum', 'depth', 'image'):
        assert torch.equal(out0[k], out1[k]), k
        assert out0[k].shape[:2] == (2, 256)
        np.testing.assert_allclose(out0[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
    assert float(out0['weights_sum'].max()) > 0.1


@pytest.mark.parametrize('which', [0, 1], ids=['batch2', 'batch8'])
def test_evaluate_3d_shares_batches_over_ranks(runs, which):
    """``evaluate_3d`` with the group, batch i on rank i % 2 and its draws
    those of batch i: every rank returns the one-process run's log vars
    (rtol 1e-12: the ranks' f64 sums are added in another order), holds
    every batch's fed features in batch order (atol 1e-6) and so the same
    FID and KID (rtol 1e-6); the ranks' results are the same bits.  With
    batches of 8 rank 1 evaluates no batch."""
    ref_logs, ref_feats, ref_result = runs['single_eval'][which]
    outs = [res['eval'][which] for res in runs['results']]
    assert ref_feats.shape[0] == EVAL_SCENES * EVAL_VIEWS
    for logs, feats, result in outs:
        assert set(logs) == set(ref_logs) == {'code_rms'}
        for k in ref_logs:
            np.testing.assert_allclose(logs[k], ref_logs[k], rtol=1e-12)
        np.testing.assert_allclose(feats, ref_feats, rtol=0, atol=1e-6)
        assert set(result) == set(ref_result)
        for k in ref_result:
            np.testing.assert_allclose(result[k], ref_result[k], rtol=1e-6,
                                       err_msg=k)
    (l0, f0, r0), (l1, f1, r1) = outs
    assert l0 == l1 and r0 == r1
    np.testing.assert_array_equal(f0, f1)


def test_allgather_weighted_sums_on_every_rank(runs):
    """Rank r adds (r + 1)^2 with weight r + 1: every rank holds the
    weighted mean (1 + 4) / (1 + 2) = 5/3 (``tests/multihost_worker.py``'s
    check of the JAX gather)."""
    for res in runs['results']:
        sums, weights = res['gathered']
        assert abs(sums['metric'] / weights['metric'] - 5.0 / 3.0) < 1e-12


@pytest.mark.parametrize('cache_size,world', [(10, 2), (2458, 2), (2458, 3),
                                              (7, 4), (3, 1)])
def test_bank_shards_match_jax(cache_size, world):
    """Each rank's bank shard (offset, size) is JAX's; the shards are
    disjoint and cover the bank; an id outside the shard raises."""
    covered = []
    for rank in range(world):
        t = DeviceSceneCache(cache_size, (1, 1, 1, 1), 4, rank=rank,
                             world_size=world)
        j = JaxHostCache(cache_size, (1, 1, 1, 1), 4, rank=rank,
                         world_size=world)
        assert (t.offset, t.local_size) == (j.offset, j.local_size)
        assert (t.offset, t.offset + t.local_size) == shard_bounds(
            cache_size, rank, world)
        assert t.code_.shape[0] == t.local_size == len(t.seen)
        covered += list(range(t.offset, t.offset + t.local_size))
        if t.offset > 0:
            with pytest.raises(IndexError):
                t.load([t.offset - 1])
    assert covered == list(range(cache_size))


@pytest.mark.parametrize('cache_16bit', [False, True])
def test_rank_bank_files_load_across_packages(cache_16bit):
    """Rank 1 of 2's bank ``state_dict`` (as its ``cache_rank1.npz``
    holds it) loads in the other package's cache of rank 1, both ways,
    rows by scene id."""
    cs, grid, n = (3, 2, 4, 4), 8, 9
    rng = np.random.RandomState(3)
    t = HostSceneCache(n, cs, grid, cache_16bit=cache_16bit, rank=1,
                       world_size=2)
    ids = np.arange(t.offset, t.offset + 3)
    code = _t(rng.randn(3, *cs).astype(np.float32))
    from ssdnerf_torch.models.autodecoders.base import adam_init
    opt = adam_init(code)
    opt.m += 0.25
    t.save(ids, code, opt, _t(rng.rand(3, grid ** 3).astype(np.float16)),
           _t(rng.randint(0, 255, (3, grid ** 3 // 8)).astype(np.uint8)))
    j = JaxDeviceCache(n, cs, grid, cache_16bit=cache_16bit, rank=1,
                       world_size=2)
    j.load_state_dict(t.state_dict())
    jb = j.load(ids)
    tb = t.load(ids)
    np.testing.assert_array_equal(np.asarray(jb['code_']),
                                  tb['code_'].numpy())
    np.testing.assert_array_equal(np.asarray(jb['opt'].m),
                                  tb['opt'].m.numpy())
    np.testing.assert_array_equal(np.asarray(jb['density_bitfield']),
                                  tb['density_bitfield'].numpy())
    back = DeviceSceneCache(n, cs, grid, cache_16bit=cache_16bit, rank=1,
                            world_size=2)
    back.load_state_dict({k: np.asarray(v) for k, v in
                          j.state_dict().items()})
    for k in DeviceSceneCache.KEYS:
        assert torch.equal(getattr(back, k), getattr(t, k)), k
    assert back.seen.tolist() == t.seen.tolist()
