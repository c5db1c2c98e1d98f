"""Plain versions of the port's march, decode (f32 and bf16 modes, and
the decode's backward) and attention kernels vs the JAX package's Pallas
kernels (interpret mode) and XLA paths on the CPU.  The kernels themselves
are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ssdnerf_tpu.models.architecture.unet import SelfAttention as JSelfAttn
from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDecoder
from ssdnerf_tpu.ops import march_rays, near_far_from_aabb, packbits
from ssdnerf_tpu.ops.pallas.attention import vmem_attention
from ssdnerf_tpu.ops.pallas.decode import decode_reference, triplane_decode
from ssdnerf_tpu.ops.pallas.march import march_valid_mask, occupancy_table
from ssdnerf_torch.convert import load_params
from ssdnerf_torch.models.architecture.unet import SelfAttention
from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops.kernels import attention as tattn
from ssdnerf_torch.ops.kernels import decode as tdec
from ssdnerf_torch.ops.kernels import march as tmarch

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _noisy(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(
            np.float32), tree)


# ------------------------------------------------------------------ march
def _march_scene(H=64, S=2, R=64, seed=1):
    rng = np.random.RandomState(seed)
    coords = np.stack(np.meshgrid(*[np.arange(H)] * 3, indexing='ij'),
                      -1).reshape(-1, 3)
    r2 = ((coords - H / 2 + 0.5) ** 2).sum(-1)
    grid = np.broadcast_to((r2 < (H * 0.3) ** 2).astype(np.float32),
                           (S, H ** 3)).copy()
    grid[1] = rng.rand(H ** 3) < 0.05
    bitfield = np.asarray(packbits(jnp.asarray(grid), 0.5))
    rays_o = rng.randn(S, R, 3).astype(np.float32) * 0.1 + [0., 0., 2.5]
    rays_d = -rays_o + rng.randn(S, R, 3).astype(np.float32) * 0.3
    rays_d = (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
              ).astype(np.float32)
    aabb = jnp.asarray([-1.0] * 3 + [1.0] * 3)
    nears, fars = near_far_from_aabb(jnp.asarray(rays_o),
                                     jnp.asarray(rays_d), aabb, 0.2)
    return bitfield, rays_o, rays_d, np.asarray(nears), np.asarray(fars)


def test_march_plain_bit_exact_vs_pallas_kernel():
    """The Pallas march (interpret mode) and the port's plain lookup on the
    same quantized samples: the voxels are computed once, with the JAX
    arithmetic of ``march_valid_mask``, and handed to both.  Identical
    bits."""
    from ssdnerf_tpu.ops.marching import t_at_step
    H, T = 64, 256
    bitfield, ro, rd, nears, fars = _march_scene(H)
    dtg = jnp.asarray([0.0, 0.004], jnp.float32)
    dt_min, dt_max = 2 * np.sqrt(3) / T, 2 * np.sqrt(3) / H
    t = t_at_step(jnp.asarray(nears), jnp.arange(T, dtype=jnp.float32),
                  dtg[:, None, None], dt_min, dt_max)

    def voxel(c):
        x = jnp.clip(ro[..., None, c] + t * rd[..., None, c], -1.0, 1.0)
        return jnp.clip((0.5 * (x + 1.0) * H).astype(jnp.int32), 0, H - 1)

    lin = (voxel(0) * H + voxel(1)) * H + voxel(2)
    lin = np.asarray(jnp.where(t < fars[..., None], lin, -1))
    assert (lin < 0).any() and (lin >= 0).any()
    pack = np.concatenate([ro, rd, nears[..., None], fars[..., None]], -1)
    ref = march_valid_mask(
        jnp.asarray(pack), occupancy_table(jnp.asarray(bitfield), H), dtg,
        T=T, grid_size=H, bound=1.0, max_steps=T, interpret=True)
    S, R = nears.shape
    got = tmarch.occupancy_lookup(_t(lin.reshape(S, R * T)), _t(bitfield))
    np.testing.assert_array_equal(got.numpy().reshape(S, R, T),
                                  np.asarray(ref) > 0.5)


def test_march_valid_mask_matches_pallas_and_xla_march():
    """The port's whole march (torch t grid + voxelization + lookup) vs
    the Pallas march (interpret) and the XLA march_rays: samples right at
    a voxel boundary may quantize differently across f32 libraries, so
    ~all (>= 99.8%) must agree, as in the JAX package's own test."""
    H, T = 64, 256
    bitfield, ro, rd, nears, fars = _march_scene(H)
    S = ro.shape[0]
    dtg = np.array([0.0, 0.004], np.float32)
    dt_min, dt_max = 2 * np.sqrt(3) / T, 2 * np.sqrt(3) / H
    noise = np.random.RandomState(3).rand(*nears.shape).astype(np.float32)
    t0 = nears + np.clip(nears * dtg[:, None], dt_min, dt_max) * noise
    ref_xla = jax.vmap(lambda o, d, nr, fr, bf, dg, nz: march_rays(
        o, d, nr, fr, bf, H, 1.0, dg, T, nz))(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(nears),
        jnp.asarray(fars), jnp.asarray(bitfield), jnp.asarray(dtg),
        jnp.asarray(noise)).valid
    pack = np.concatenate([ro, rd, t0[..., None], fars[..., None]], -1)
    ref_pallas = march_valid_mask(
        jnp.asarray(pack), occupancy_table(jnp.asarray(bitfield), H),
        jnp.asarray(dtg), T=T, grid_size=H, bound=1.0, max_steps=T,
        interpret=True)
    got = tmarch.march_valid_mask(_t(ro), _t(rd), _t(t0), _t(fars),
                                  _t(bitfield), _t(dtg), T, H, 1.0, T)
    got = got.numpy()
    assert got.any() and not got.all()
    assert np.mean(got != np.asarray(ref_xla)) < 2e-3
    assert np.mean(got != (np.asarray(ref_pallas) > 0.5)) < 2e-3


# ----------------------------------------------------------------- decode
def _decoder_pair(C=6, hidden=64, res=32, S=2, N=300, seed=0):
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
    params = _noisy(params, seed + 1, 0.1)
    tdec_ = TriPlaneDecoder(base_layers=(3 * C, hidden),
                            density_layers=(hidden, 1),
                            color_layers=(hidden, 3),
                            dir_layers=(16, hidden), compute_dtype='float32')
    load_params(tdec_, params)
    return jdec, params, tdec_, code, xyz, dirs


def test_decode_plain_matches_xla_decoder_f32():
    """Colour and density-only decode vs the f32 XLA TriPlaneDecoder,
    atol 1e-5 (same bilinear taps, f32 sums in another order)."""
    jdec, params, tdec_, code, xyz, dirs = _decoder_pair()
    js, jr = jdec.apply(params, jnp.asarray(code), jnp.asarray(xyz),
                        jnp.asarray(dirs))
    with torch.no_grad():
        ts, tr = tdec_(_t(code), _t(xyz), _t(dirs))
        td, none = tdec_(_t(code), _t(xyz), density_only=True)
    assert none is None
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), ts.numpy(), rtol=0, atol=0)


def _pallas_operands(seed, S=2, R=8, K=64, res=128, C=6, hidden=64):
    """Codes, points, per-ray dir_out (bf16 values, as the Pallas kernel
    reads it) and decoder weights in both packages' layouts: JAX's Pallas
    kernel operands (bf16 where its renderer rounds) and the port's
    parameter block in f32 and in its bf16 form."""
    rng = np.random.RandomState(seed)
    code = rng.randn(S, 3, C, res, res).astype(np.float32)
    x, y, z = (rng.uniform(-1.05, 1.05, (S, R, K)).astype(np.float32)
               for _ in range(3))
    dir_out = _t(rng.randn(S, R, hidden) * 0.3).float().bfloat16().float()
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
    planes = _t(code).permute(0, 1, 3, 4, 2).contiguous()
    xyz = torch.stack([_t(x), _t(y), _t(z)], -1).reshape(S, R * K, 3)
    rid = torch.arange(R, dtype=torch.int32).repeat_interleave(K).expand(
        S, R * K)
    return dict(
        jplanes=jnp.asarray(code.reshape(S, 3, C * res, res)).astype(bf),
        jxyz=tuple(jnp.asarray(a) for a in (x, y, z)), jw=jw,
        jdir=jnp.asarray(dir_out.numpy()), planes=planes, xyz=xyz, rid=rid,
        dir_out=dir_out, params=params,
        params_bf16=tdec.round_weights(params, hidden, 3 * C),
        perm=perm, shape=(S, R, K), hidden=hidden, C=C, res=res)


def _near_bf16(got, ref, what):
    """Outputs at the bf16 rounding points: every element within 2^-8 of
    ref's largest entry, and their mean within 1e-5 of it.  A rounding to
    bf16 (a feature, SiLU(base)) that falls the other way after f32 sums
    in another order moves one input of a head by one bf16 ulp, which the
    head carries to the output; such flips are rare, so the mean stays at
    the f32 level."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, top = np.abs(got - ref), np.abs(ref).max()
    assert err.max() <= 2.0 ** -8 * top, (what, err.max(), top)
    assert err.mean() <= 1e-5 * top, (what, err.mean(), top)


def _ulps(got, ref, what, atol_rel=0.0):
    """|got - ref| within one bf16 ulp of each element (2^-7 relative),
    plus ``atol_rel`` of ref's largest entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7,
                               atol=atol_rel * np.abs(ref).max(),
                               err_msg=what)


def test_decode_plain_matches_decode_reference():
    """Raw outputs vs the Pallas kernel's oracle ``decode_reference`` at
    res 128 (bf16 planes and weights, f32 hats and sums): the port's bf16
    mode (bf16 planes, :func:`pack_params`' bf16 block, dir_out of bf16
    values) as ``_near_bf16``, the same rounding points with f32 sums in
    another order; its f32 mode at atol 3e-2 (the JAX
    package's own kernel-vs-reference tolerance, which the rounding to
    bf16 sets).  Density-only equals the colour call's density."""
    op = _pallas_operands(7)
    refs = decode_reference(op['jplanes'], *op['jxyz'], op['jdir'],
                            *op['jw'], op['shape'][2])
    for planes, params in ((op['planes'].bfloat16(), op['params_bf16']),
                           (op['planes'], op['params'])):
        args = (planes, op['xyz'], params, op['hidden'])
        sig, rgb = tdec.triplane_decode(*args, op['rid'], op['dir_out'])
        sig_d, _ = tdec.triplane_decode(*args)
        outs = [sig, rgb[..., 0], rgb[..., 1], rgb[..., 2]]
        for o, r, name in zip(outs, refs, 'sigma r g b'.split()):
            o = o.reshape(op['shape']).numpy()
            if planes.dtype == torch.bfloat16:
                _near_bf16(o, r, name)
            else:
                np.testing.assert_allclose(o, np.asarray(r), rtol=0,
                                           atol=3e-2, err_msg=name)
        np.testing.assert_array_equal(sig_d.numpy(), sig.numpy())


@pytest.mark.parametrize('colour', [True, False])
def test_decode_bf16_plain_and_backward_match_pallas_kernel(colour):
    """The bf16 plain decode and its backward (autograd through the
    rounding points, ``triplane_decode_backward``) vs the Pallas
    ``triplane_decode`` in interpret mode and its custom VJP, colour and
    density-only (JAX's density-only operands: zero dir_out and colour
    head).  Forward as ``_near_bf16`` (outputs of order 4); gradients
    within one bf16 ulp of each element, the f32 sums (biases, dir_out)
    besides within 1e-4 of their largest entry: a bf16 rounding that falls
    the other way after f32 sums in another order moves an element by one
    ulp.  The planes' and weights' gradients come back bf16-rounded,
    dir_out's and the biases' f32."""
    op = _pallas_operands(8, R=16, res=32)
    S, R, K = op['shape']
    hidden, C, res = op['hidden'], op['C'], op['res']
    rng = np.random.RandomState(9)
    gs = rng.randn(S, R, K).astype(np.float32)
    gr = (rng.randn(S, R, K, 3) if colour
          else np.zeros((S, R, K, 3))).astype(np.float32)
    jdir = op['jdir'] if colour else jnp.zeros_like(op['jdir'])
    wbt, bbt, b1, b2, w1t, w2t = op['jw']
    if not colour:
        b2, w2t = jnp.zeros_like(b2), jnp.zeros_like(w2t)

    def jfn(planes, dir_out, wbt, bbt, b1, b2, w1t, w2t):
        return triplane_decode(planes, *op['jxyz'], None, dir_out, wbt, bbt,
                               b1, b2, w1t, w2t, K, None, True)

    outs, vjp = jax.vjp(jfn, op['jplanes'], jdir, wbt, bbt, b1, b2, w1t,
                        w2t)
    gp, gdir, gwbt, gbbt, gb1, gb2, gw1t, gw2t = vjp(
        (jnp.asarray(gs),) + tuple(jnp.asarray(gr[..., c]) for c in range(3)))

    planes = op['planes'].bfloat16()
    params = op['params_bf16']
    if not colour:
        params = params.clone()
        params[-3:] = 0.0
        params[hidden * 3 * C + 2 * hidden:-4] = 0.0
    args = (planes, op['xyz'], params, hidden) + (
        (op['rid'], op['dir_out']) if colour else (None, None))
    sig, rgb = tdec.triplane_decode(*args)
    got = [sig] + ([rgb[..., c] for c in range(3)] if colour else [])
    for o, r, name in zip(got, outs, 'sigma r g b'.split()):
        _near_bf16(o.reshape(S, R, K).numpy(), r, name)
    d_planes, d_params, d_dir = tdec.triplane_decode_backward(
        *args, _t(gs).reshape(S, R * K),
        _t(gr).reshape(S, R * K, 3) if colour else None)
    assert d_planes.dtype == torch.bfloat16 and d_params.dtype == torch.float32
    ref = np.asarray(gp.astype(jnp.float32)).reshape(
        S, 3, C, res, res).transpose(0, 1, 3, 4, 2)
    _ulps(d_planes.float().numpy(), ref, 'planes')
    wb, bb, wd, wc, bd, bc = (t.numpy() for t in tdec._unpack_params(
        d_params.bfloat16().float(), hidden, 3 * C))
    f32 = dict(zip('wb bb wd wc bd bc'.split(), tdec._unpack_params(
        d_params, hidden, 3 * C)))
    inv = np.argsort(op['perm'])
    _ulps(wb, np.asarray(gwbt.astype(jnp.float32)).T[inv].T, 'W_b')
    _ulps(f32['bb'].numpy(), np.asarray(gbbt)[:, 0], 'b_b', 1e-4)
    _ulps(wd[0], np.asarray(gw1t.astype(jnp.float32))[0], 'W_d')
    _ulps(f32['bd'].numpy(), np.asarray(gb1)[0, :1], 'b_d', 1e-4)
    if colour:
        _ulps(wc, np.asarray(gw2t.astype(jnp.float32))[:3], 'W_c')
        _ulps(f32['bc'].numpy(), np.asarray(gb2)[0, :3], 'b_c', 1e-4)
        _ulps(d_dir.numpy(), np.asarray(gdir), 'dir_out', 1e-4)
    else:
        assert d_dir is None


# -------------------------------------------------------------- attention
def test_attention_plain_matches_vmem_attention():
    """G=2, T=512, hd=64 vs the Pallas kernel in interpret mode; both f32,
    atol 1e-5."""
    rng = np.random.RandomState(8)
    q, k, v = (rng.randn(2, 512, 64).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(64)
    ref = vmem_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale, True)
    out = tattn.attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_self_attention_module_matches_flax():
    """The UNet's attention block (GN, qkv layout, heads, residual) vs the
    Flax module with the XLA core: atol 1e-4."""
    x = np.random.RandomState(9).randn(2, 16, 16, 128).astype(np.float32)
    jm = JSelfAttn(4, 1, 32, attn_kernel=False)
    params = _noisy(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 10)
    ref = jm.apply(params, jnp.asarray(x))
    tm = SelfAttention(128, 4, 32)
    load_params(tm, params)
    with torch.no_grad():
        out = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
