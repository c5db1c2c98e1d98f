"""The forward-only variants of the port's packed render vs the JAX package
on the CPU: the banded routing (``ops/packing.py``), the plain versions of
the fused decode + composite and of the banded decode against the Pallas
kernels in interpret mode, whole renders with ``fused_composite`` and with
``banded_decode`` (guard engaged and declined), the raise under autograd,
and the packed-branch condition (a render the JAX package does per ray,
the port did packed and truncated).  The slice with ``fused_composite`` is
``tests/test_torch_slice.py::test_val_uncond_and_render_fused_composite_
match_jax``, beside the slice test whose JAX compilations it reuses."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import look_at_pose
from ssdnerf_tpu.models.decoders.renderer import (
    volume_render as jax_volume_render)
from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDecoder
from ssdnerf_tpu.ops import get_cam_rays, near_far_from_aabb, packbits
from ssdnerf_tpu.ops import packing as jpack
from ssdnerf_tpu.ops.marching import (SQRT3, compact_samples, march_rays,
                                      t_at_step)
from ssdnerf_tpu.ops.pallas.decode import (SUB, triplane_decode_banded,
                                           triplane_decode_composite)
from ssdnerf_torch.convert import load_params
from ssdnerf_torch.models.decoders import renderer as trenderer
from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops import packing as tpack
from ssdnerf_torch.ops.kernels import decode as tdec

torch.set_num_threads(2)

GR = 16


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the two variants' plain versions (what their
    wrappers run for CPU tensors)."""
    calls = {}
    for name in ('triplane_decode_composite_plain',
                 'triplane_decode_banded_plain'):
        def counted(*args, _fn=getattr(tdec, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(tdec, name, counted)
    return calls


def _np(a):
    return np.array(a)


# ---------------------------------------------------------------- routing
def _camera_scene(S=2, hw=16, grid=64, seed=0):
    """Image-coherent rays from one look-at camera and a ball occupancy
    (radius 0.35 grid), as ``tests/test_packing.py:_camera_scene``: the
    banded guard engages there."""
    code = (0.5 * np.random.RandomState(seed).randn(S, 3, 6, 128, 128)
            ).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing='ij'),
                      -1).reshape(-1, 3)
    occ = ((coords - grid / 2 + 0.5) ** 2).sum(-1) < (grid * 0.35) ** 2
    bitfield = _np(packbits(jnp.asarray(np.broadcast_to(
        occ.astype(np.float32), (S, grid ** 3)).copy()), 0.5))
    pose = np.broadcast_to(look_at_pose([1.8, 0.6, 1.8]), (S, 1, 4, 4))
    f = hw * 131.25 / 128
    intr = np.broadcast_to(np.array([f, f, hw / 2, hw / 2], np.float32),
                           (S, 1, 4))
    o, d = get_cam_rays(jnp.asarray(pose), jnp.asarray(intr), hw, hw)
    return (code, _np(o).reshape(S, -1, 3), _np(d).reshape(S, -1, 3),
            bitfield)


def _scattered_scene(seed, S=2, n_rays=64, grid=64):
    """Rays in random directions through a ball plus noise voxels
    (``tests/test_pallas_renderer.py:_scene``): tiles lose coherence and
    the banded guard declines."""
    rng = np.random.RandomState(seed)
    code = (0.5 * rng.randn(S, 3, 6, 128, 128)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing='ij'),
                      -1).reshape(-1, 3)
    occ = ((((coords - grid / 2 + 0.5) ** 2).sum(-1) < (grid * 0.35) ** 2)
           | (rng.rand(grid ** 3) < 0.02))
    bitfield = _np(packbits(jnp.asarray(np.broadcast_to(
        occ.astype(np.float32), (S, grid ** 3)).copy()), 0.5))
    o = rng.randn(S, n_rays, 3).astype(np.float32) * 0.2
    o[..., 2] += 2.2
    d = -o + rng.randn(S, n_rays, 3).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return code, o, d, bitfield


def _compacted(o, d, bitfield, dt_gamma, K=64, grid=64, T=256):
    """JAX's march + compaction and the source-layout t of each sample."""
    S = o.shape[0]
    nears, fars = near_far_from_aabb(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray([-1.0] * 3 + [1.0] * 3),
                                     0.2)
    res = jax.vmap(lambda o_, d_, nr, fr, bf: march_rays(
        o_, d_, nr, fr, bf, grid, 1.0, dt_gamma, T))(
        jnp.asarray(o), jnp.asarray(d), nears, fars, jnp.asarray(bitfield))
    comp_step, comp_valid = compact_samples(res.valid, K)
    ts = t_at_step(nears, comp_step, jnp.full((S, 1, 1), dt_gamma),
                   2 * SQRT3 / T, 2 * SQRT3 / grid)
    return _np(comp_step), _np(comp_valid), _np(ts)


def test_band_keys_and_payload_match_jax():
    """Morton band keys equal, hat-row extents atol 1e-6, on the coherent
    camera scene's compacted samples."""
    _, o, d, bitfield = _camera_scene()
    _, comp_valid, ts = _compacted(o, d, bitfield, 0.5 / 131.25)
    rk, rp = jpack.band_keys_and_payload(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(ts),
                                         jnp.asarray(comp_valid), 1.0, 128)
    tk, tp = tpack.band_keys_and_payload(_t(o), _t(d), _t(ts),
                                         _t(comp_valid), 1.0, 128)
    assert len(np.unique(np.asarray(rk))) > 8
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=0, atol=1e-6)


@pytest.mark.parametrize('P', [1024, 256])
def test_pack_groups_banded_matches_jax(P):
    """Lossless (P=1024) and truncating (P=256) budgets: both layouts equal
    JAX's (ray ids compared on valid slots, as the JAX package's own test
    does), the port's index-map ``route_back`` gives JAX's one-hot
    ``route_back`` of the same channels, and the routed payload and its
    liveness channel are equal."""
    rng = np.random.RandomState(2)
    S, R, K = 2, 32, 64
    n_valid = rng.randint(0, K + 1, (S, R))
    comp_valid = np.arange(K) < n_valid[..., None]
    comp_step = np.where(comp_valid, np.sort(
        rng.randint(0, 256, (S, R, K)), -1), 0).astype(np.float32)
    band = rng.randint(0, 256, (S, R, K // 8)).astype(np.int32)
    payload = rng.rand(S, R, K // 8, 4).astype(np.float32)
    rray, rband, rconv, rpay = jpack.pack_groups_banded(
        jnp.asarray(comp_step), jnp.asarray(comp_valid), jnp.asarray(band),
        P, GR, block_payload=jnp.asarray(payload))
    tray, tband, tconv, tpay = tpack.pack_groups_banded(
        _t(comp_step), _t(comp_valid), _t(band), P, GR, _t(payload))
    for name, got, ref in (('ray', tray, rray), ('band', tband, rband)):
        valid = np.asarray(ref[1])
        for i, (a, b) in enumerate(zip(got, ref)):
            a, b = a.numpy(), np.asarray(b)
            if i == 2:       # ray ids of dead slots are don't-care
                a, b = np.where(valid, a, 0), np.where(valid, b, 0)
            np.testing.assert_array_equal(a, b, err_msg=f'{name} {i}')
    assert not np.asarray(rband[1]).all()
    chans = [rng.randn(S, R // GR, P).astype(np.float32) for _ in range(2)]
    ref = jpack.route_back(rconv, [jnp.asarray(c) for c in chans])
    got = tpack.route_back(tconv, [_t(c) for c in chans])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tpay.numpy(), np.asarray(rpay), atol=1e-6)
    np.testing.assert_array_equal(tpay[..., 4].numpy() > 0.5,
                                  np.asarray(rpay)[..., 4] > 0.5)


@pytest.mark.parametrize('scene,engages', [('camera', True),
                                           ('scattered', False)])
def test_banded_windows_match_jax(scene, engages):
    """Per-tile windows equal JAX's, and so is the exactness guard: true on
    the coherent camera scene, false on scattered rays (as
    ``tests/test_packing.py:294-356``)."""
    if scene == 'camera':
        _, o, d, bitfield = _camera_scene()
        dt_gamma = 0.5 / 131.25
    else:
        _, o, d, bitfield = _scattered_scene(9)
        dt_gamma = 0.004
    comp_step, comp_valid, ts = _compacted(o, d, bitfield, dt_gamma)
    bandk, payload = jpack.band_keys_and_payload(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts),
        jnp.asarray(comp_valid), 1.0, 128)
    _, _, _, rpay = jpack.pack_groups_banded(
        jnp.asarray(comp_step), jnp.asarray(comp_valid), bandk, 512, GR,
        block_payload=payload)
    rwin, rok = jpack.banded_windows(rpay, 128, tdec.BAND_W, tdec.TILE)
    twin, tok = tpack.banded_windows(_t(rpay), 128, tdec.BAND_W, tdec.TILE)
    assert bool(rok) == engages and bool(tok) == engages
    np.testing.assert_array_equal(twin.numpy().reshape(-1),
                                  np.asarray(rwin).reshape(-1))
    assert (twin.numpy() % 16 == 0).all() and twin.max() < 128 << 8


# ---------------------------------------------------------------- kernels
def _mlp(rng, C, hidden):
    """Decoder weights in both packages' layouts: the port's parameter
    block and JAX's kernel operands (bf16 where its kernels round)."""
    wb = (rng.randn(3 * C, hidden) * 0.2).astype(np.float32)  # rows c*3+p
    bb = (rng.randn(hidden) * 0.1).astype(np.float32)
    wd = (rng.randn(hidden) * 0.3).astype(np.float32)
    wc = (rng.randn(3, hidden) * 0.3).astype(np.float32)
    bd, bc = np.float32(0.1), (rng.randn(3) * 0.1).astype(np.float32)
    perm = [c * 3 + p for p in range(3) for c in range(C)]
    w1t = np.zeros((128, hidden), np.float32)
    w1t[0] = wd
    w2t = np.zeros((128, hidden), np.float32)
    w2t[:3] = wc
    b1 = np.zeros((1, 128), np.float32)
    b1[0, 0] = bd
    b2 = np.zeros((1, 128), np.float32)
    b2[0, :3] = bc
    bf = jnp.bfloat16
    jw = (jnp.asarray(wb[perm].T).astype(bf), jnp.asarray(bb[:, None]),
          jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(w1t).astype(bf),
          jnp.asarray(w2t).astype(bf))
    params = torch.cat([_t(wb.T).reshape(-1), _t(bb), _t(wd),
                        _t(wc).reshape(-1), torch.tensor([bd]), _t(bc)])
    return jw, params


def _packed_operands(seed, S=2, R=64, K=64, P=512, res=128, C=6,
                     hidden=64):
    """A truncating packed layout (16-ray groups of random valid counts)
    with per-slot positions, t and dt, decoder weights and planes."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(0, K + 1, (S, R))
    comp_valid = np.arange(K) < n_valid[..., None]
    comp_step = np.where(comp_valid, np.arange(K), 0).astype(np.float32)
    _, pvalid, prid, soffs = (a.numpy() for a in tpack.pack_groups(
        _t(comp_step), _t(comp_valid), P, GR))
    G = R // GR
    xyz = rng.uniform(-1, 1, (S, G, P, 3)).astype(np.float32)
    pt = (np.cumsum(rng.rand(S, G, P), -1) * 0.01 + 0.5).astype(np.float32)
    pdt = (rng.rand(S, G, P) * 0.1 + 0.01).astype(np.float32)
    code = rng.randn(S, 3, C, res, res).astype(np.float32)
    dir_out = (rng.randn(S, R, hidden) * 0.3).astype(np.float32)
    jw, params = _mlp(rng, C, hidden)
    return dict(code=code, xyz=xyz, pt=pt, pdt=pdt, pvalid=pvalid,
                prid=prid, soffs=soffs, dir_out=dir_out, jw=jw,
                params=params, hidden=hidden)


def _port_composite(op, plain):
    S, G, P = op['pt'].shape
    planes = _t(op['code']).permute(0, 1, 3, 4, 2).contiguous()
    rid = (_t(op['prid']) + GR * torch.arange(G)[:, None]).reshape(
        S, G * P).to(torch.int32)
    args = (planes, _t(op['xyz']).reshape(S, G * P, 3), op['params'],
            op['hidden'], rid, _t(op['dir_out']))
    if plain:
        return tdec.triplane_decode_composite(
            *args, _t(op['pt']), _t(op['pdt']), _t(op['pvalid']),
            _t(op['soffs']).to(torch.int32), GR, 0.001, 1e-4)
    sig, rgb = tdec.activate(*tdec.triplane_decode_plain(*args), 0.001)
    return tpack.composite_packed(
        sig.reshape(S, G, P), rgb.reshape(S, G, P, 3), _t(op['pdt']),
        _t(op['pt']), _t(op['pvalid']), _t(op['prid']), _t(op['soffs']), GR,
        64, 1e-4)


def test_decode_composite_plain_matches_pallas_and_split_path():
    """The plain fused decode + composite on a truncating packed layout vs
    the Pallas ``triplane_decode_composite`` (interpret), atol 2e-2 (JAX
    rounds planes and weights to bf16, as test_decode_plain_matches_
    decode_reference states), and vs the port's split path (plain decode,
    activation, ``composite_packed``), atol 1e-5."""
    op = _packed_operands(20)
    S, G, P = op['pt'].shape
    ws, depth, image = _port_composite(op, plain=True)
    split = _port_composite(op, plain=False)
    for a, b, name in zip((ws, depth, image), split, 'ws depth image'.split()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert 0.05 < ws.max() <= 1.0 and (ws == 0).any()   # truncated rays
    gps = SUB // P
    rid_local = op['prid'] + GR * (np.arange(G) % gps)[None, :, None]
    starts = np.zeros((S, G, P), np.float32)
    for s in range(S):
        for g in range(G):
            for r in range(GR):
                if op['soffs'][s, g, r] < P:
                    starts[s, g, op['soffs'][s, g, r]] = 1.0
    bf = jnp.bfloat16
    planes = jnp.asarray(op['code'].reshape(S, 3, -1, 128)).astype(bf)
    x, y, z = (jnp.asarray(op['xyz'][..., c]) for c in range(3))
    ref = triplane_decode_composite(
        planes, x, y, z, jnp.asarray(rid_local.astype(np.int32)),
        jnp.asarray(op['pt']), jnp.asarray(op['pdt']),
        jnp.asarray(op['pvalid'].astype(np.float32)), jnp.asarray(starts),
        jnp.asarray(op['dir_out']), *op['jw'], P, gps * GR, 0.001, 1e-4,
        True)
    got = (ws, depth) + tuple(image.unbind(-1))
    for a, b, name in zip(got, ref, 'ws depth r g b'.split()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-2, err_msg=name)


def test_decode_banded_plain_matches_pallas_and_full_decode():
    """The plain banded decode on tile-coherent coordinates whose taps fit
    the declared windows (``tests/test_pallas_kernels.py:147-183``) vs the
    Pallas ``triplane_decode_banded`` (interpret), atol 3e-2 (bf16 planes
    and weights there), and vs the full plain decode within 1e-6; taps
    outside a window count zero."""
    rng = np.random.RandomState(13)
    S, R, K, res, C, hidden = 2, 16, 64, 128, 6, 64
    tile, band_w = tdec.TILE, tdec.BAND_W
    N = R * K
    n_tiles = N // tile

    def windowed_coord(lo_all):
        f = np.stack([[rng.uniform(lo + 1.0, lo + band_w - 2.0, tile)
                       for lo in lo_all[s]] for s in range(S)])
        return ((f + 0.5) * (2.0 / res) - 1.0).astype(np.float32).reshape(
            S, N)

    lox = rng.randint(0, (res - band_w) // 16 + 1, (S, n_tiles)) * 16
    loy = rng.randint(0, (res - band_w) // 16 + 1, (S, n_tiles)) * 16
    x, y = windowed_coord(lox), windowed_coord(loy)
    z = rng.uniform(-1, 1, (S, N)).astype(np.float32)
    win = (lox | (loy << 8)).astype(np.int32)
    code = rng.randn(S, 3, C, res, res).astype(np.float32)
    dir_out = (rng.randn(S, R, hidden) * 0.3).astype(np.float32)
    jw, params = _mlp(rng, C, hidden)
    planes = _t(code).permute(0, 1, 3, 4, 2).contiguous()
    xyz = torch.stack([_t(x), _t(y), _t(z)], -1)
    rid = torch.arange(R, dtype=torch.int32).repeat_interleave(K).expand(
        S, N).contiguous()
    sig, rgb = tdec.triplane_decode_banded(planes, xyz, params, hidden, rid,
                                           _t(dir_out), _t(win))
    full = tdec.triplane_decode_plain(planes, xyz, params, hidden, rid,
                                      _t(dir_out))
    np.testing.assert_allclose(sig.numpy(), full[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), full[1].numpy(), atol=1e-6)
    bf = jnp.bfloat16
    planesT = jnp.asarray(code.reshape(S, 3, C * res, res)).astype(
        bf).swapaxes(-1, -2)
    ref = triplane_decode_banded(
        planesT, *(jnp.asarray(a.reshape(S, R, K)) for a in (x, y, z)), None,
        jnp.asarray(win.reshape(S * N // SUB, SUB // tile)),
        jnp.asarray(dir_out), *jw, K, rpc=SUB // K, interpret=True)
    got = (sig,) + tuple(rgb.unbind(-1))
    for a, b, name in zip(got, ref, 'sigma r g b'.split()):
        np.testing.assert_allclose(a.numpy().reshape(S, R, K), np.asarray(b),
                                   rtol=0, atol=3e-2, err_msg=name)
    # a window that misses the taps zeroes them: x windows moved away
    moved = _t((((lox + 64) % 128) | (loy << 8)).astype(np.int32))
    sig_m, _ = tdec.triplane_decode_banded(planes, xyz, params, hidden, rid,
                                           _t(dir_out), moved)
    assert (sig_m - sig).abs().max() > 1e-2


# ---------------------------------------------------------------- renders
def _render_decoders(seed=40, **fields):
    """JAX decoder (Pallas kernels in interpret mode) and the port's, the
    same weights (JAX init plus noise, so the direction branch is live),
    with the decoder fields ``fields`` set on both."""
    jdec = JDecoder(backend='pallas-interpret', compact_steps=64, **fields)
    params = jdec.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 6, 128, 128)),
                       jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), params)
    tdec_ = TriPlaneDecoder(compact_steps=64, **fields)
    load_params(tdec_, params)
    return jdec, params, tdec_


def _renders(scene, dt_gamma, **fields):
    """(JAX render, port render with ``fields``, port render without)."""
    code, o, d, bitfield = scene
    jdec, params, tdec_ = _render_decoders(**fields)
    ref = jax_volume_render(jdec, jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(code), jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(bitfield), 64, dt_gamma=dt_gamma)
    split = copy.copy(tdec_)
    split.fused_composite = split.banded_decode = False
    with torch.no_grad():
        args = (_t(code), _t(o), _t(d), _t(bitfield), 64)
        got = trenderer.volume_render(tdec_, *args, dt_gamma=dt_gamma)
        plain = trenderer.volume_render(split, *args, dt_gamma=dt_gamma)
    return ref, got, plain


def _check_render(ref, got, plain):
    """Variant vs JAX's render of the same variant at the tolerances of
    ``tests/test_packing.py:335-337`` (bf16 kernel renders, 2e-2 / 2e-2 /
    3e-2), and vs the port's split render at 1e-5."""
    assert np.asarray(ref['weights_sum']).max() > 0.1
    for k, atol in (('weights_sum', 2e-2), ('image', 2e-2), ('depth', 3e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_fused_composite_render_matches_jax(plain_calls):
    """``fused_composite`` renders (P=512, 64 rays, overflowing groups)
    through ``triplane_decode_composite``, against JAX's fused render."""
    _check_render(*_renders(_scattered_scene(7), 0.004, pack_slots=512,
                            fused_composite=True))
    assert plain_calls == {'triplane_decode_composite_plain': 1}


@pytest.mark.parametrize('scene,engages', [('camera', True),
                                           ('scattered', False)])
def test_banded_render_matches_jax(scene, engages, plain_calls):
    """``banded_decode`` renders: the coherent camera scene engages the
    banded decode, scattered rays decline it (full decode of the ray
    layout, as JAX's ``lax.cond`` does); both against JAX's banded render."""
    if scene == 'camera':
        args = (_camera_scene(), 0.5 / 131.25)
    else:
        args = (_scattered_scene(9), 0.004)
    vr = trenderer.volume_render
    before = (vr.banded_engaged, vr.banded_declined)
    _check_render(*_renders(*args, pack_slots=512, banded_decode=True))
    assert (vr.banded_engaged - before[0], vr.banded_declined
            - before[1]) == ((1, 0) if engages else (0, 1))
    assert plain_calls == ({'triplane_decode_banded_plain': 1} if engages
                           else {})


def test_forward_only_variants_raise_under_autograd():
    """Both variants raise where the codes need a gradient; the wrappers
    raise for a decoder parameter that needs one."""
    for fields, scene in (({'fused_composite': True}, _scattered_scene(7)),
                          ({'banded_decode': True}, _camera_scene())):
        code, o, d, bitfield = scene
        _, _, dec = _render_decoders(pack_slots=512, **fields)
        with pytest.raises(RuntimeError, match='forward only'):
            trenderer.volume_render(dec, _t(code).requires_grad_(), _t(o),
                                    _t(d), _t(bitfield), 64,
                                    dt_gamma=0.5 / 131.25)
    op = _packed_operands(21)
    op['params'].requires_grad_()
    with pytest.raises(RuntimeError, match='forward only'):
        _port_composite(op, plain=True)
    with pytest.raises(RuntimeError, match='forward only'):
        tdec.triplane_decode_banded(
            torch.zeros(1, 3, 128, 128, 6), torch.zeros(1, 128, 3),
            op['params'], 64, torch.zeros(1, 128, dtype=torch.int32),
            torch.zeros(1, 1, 64), torch.zeros(1, 1, dtype=torch.int32))


def test_packed_branch_condition_matches_jax():
    """16 rays, P=512, K=64, every voxel occupied: one 16-ray group whose
    samples overflow 512 slots.  JAX renders it per ray
    (``(N // 16) * P % 1024 != 0``); the port must too, or its trailing
    rays lose their deepest samples.  Against JAX's render
    (``backend='pallas-interpret'``), atol 2e-2 (bf16 kernels)."""
    rng = np.random.RandomState(30)
    S, N = 1, 16
    code = (0.5 * rng.randn(S, 3, 6, 128, 128)).astype(np.float32)
    bitfield = np.full((S, 64 ** 3 // 8), 255, np.uint8)
    o = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (S, N, 1))
    o[..., :2] += rng.uniform(-0.3, 0.3, (S, N, 2))
    d = -o + rng.randn(S, N, 3).astype(np.float32) * 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref, got, _ = _renders((code, o, d, bitfield), 0.0, pack_slots=512)
    assert np.asarray(ref['weights_sum']).min() > 0.1
    for k, atol in (('weights_sum', 2e-2), ('image', 2e-2), ('depth', 3e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, err_msg=k)
    assert not trenderer.packed_branch(512, 64, N)
    assert trenderer.packed_branch(512, 64, 2 * N)
