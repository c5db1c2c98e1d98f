"""ssdnerf_torch ops vs ssdnerf_tpu ops on the CPU, same numpy inputs."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ssdnerf_tpu import ops as jops
from ssdnerf_tpu.ops import marching as jmarch
from ssdnerf_tpu.ops import packing as jpack
from ssdnerf_torch import ops as tops

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_t_at_step_matches_jax():
    """Closed-form t grid in all three phases; the same f32 op order on
    both sides, so agreement is to a few ulp (rtol 1e-6)."""
    rng = np.random.RandomState(0)
    S, R, T = 3, 64, 128
    t0 = rng.uniform(0.2, 2.0, (S, R)).astype(np.float32)
    dtg = np.array([0.0, 0.004, 0.05], np.float32)
    k = np.arange(T, dtype=np.float32)
    dt_min, dt_max = 2 * np.sqrt(3) / 256, 2 * np.sqrt(3) / 64
    ref = jmarch.t_at_step(jnp.asarray(t0), jnp.asarray(k),
                           jnp.asarray(dtg)[:, None, None], dt_min, dt_max)
    out = tops.t_at_step(_t(t0), _t(k), _t(dtg)[:, None, None], dt_min,
                         dt_max)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_compact_samples_matches_jax():
    """Exact: step indices are small integers in f32."""
    rng = np.random.RandomState(1)
    valid = rng.rand(2, 50, 96) < 0.3
    valid[0, :5] = True                      # rays that overflow K
    for K in (16, 24):
        rs, rv = jmarch.compact_samples(jnp.asarray(valid), K)
        ts, tv = tops.compact_samples(_t(valid), K)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_pack_groups_matches_jax():
    """Exact routing, including overflowing groups (budget truncation)."""
    rng = np.random.RandomState(2)
    S, R, K, P = 2, 64, 32, 128
    n_valid = rng.randint(0, K + 1, (S, R))
    comp_valid = np.arange(K) < n_valid[..., None]
    comp_step = np.where(comp_valid, np.cumsum(
        rng.randint(1, 4, (S, R, K)), -1), 0).astype(np.float32)
    ref = jpack.pack_groups(jnp.asarray(comp_step), jnp.asarray(comp_valid),
                            P, 16)
    out = tops.pack_groups(_t(comp_step), _t(comp_valid), P, 16)
    for o, r, name in zip(out, ref, ('pstep', 'pvalid', 'prid', 'soffs')):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                      err_msg=name)


def _packed_case(seed, sig_scale):
    rng = np.random.RandomState(seed)
    S, R, K, Gr, P = 2, 32, 64, 16, 1024
    n_valid = rng.randint(0, K + 1, (S, R))
    comp_valid = np.arange(K) < n_valid[..., None]
    sig = (rng.rand(S, R, K) ** 4 * sig_scale).astype(np.float32)
    rgb = rng.rand(S, R, K, 3).astype(np.float32)
    ts = np.sort(rng.rand(S, R, K).astype(np.float32) * 2, -1) + 0.5
    dts = rng.rand(S, R, K).astype(np.float32) * 0.05 + 0.002
    comp_step = np.broadcast_to(np.arange(K, dtype=np.float32), (S, R, K))
    pstep, pvalid, prid, soffs = jpack.pack_groups(
        jnp.asarray(comp_step), jnp.asarray(comp_valid), P, Gr)
    G = R // Gr
    ps = np.asarray(pstep).astype(np.int64)
    pr = np.asarray(prid)
    s_i = np.arange(S)[:, None, None]
    r_i = np.arange(G)[None, :, None] * Gr + pr

    def route(a):
        return a[s_i, r_i, ps]

    return dict(dense=(sig, rgb, dts, ts, comp_valid),
                packed=(route(sig), route(rgb), route(dts), route(ts),
                        np.asarray(pvalid), pr, np.asarray(soffs)),
                Gr=Gr, K=K)


def test_composite_packed_matches_jax():
    """Moderate densities: the port's packed composite vs the JAX packed
    composite, f32 sums in another order (atol 1e-5)."""
    case = _packed_case(4, 30.0)
    sig, rgb, dts, ts, pvalid, prid, soffs = case['packed']
    ref = jpack.composite_packed(
        jnp.asarray(sig), tuple(jnp.asarray(rgb[..., c]) for c in range(3)),
        jnp.asarray(dts), jnp.asarray(ts), jnp.asarray(pvalid),
        jnp.asarray(prid), jnp.asarray(soffs), case['Gr'])
    out = tops.composite_packed(_t(sig), _t(rgb), _t(dts), _t(ts),
                                _t(pvalid), _t(prid).long(),
                                _t(soffs).long(), case['Gr'], case['K'])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_composite_packed_saturated_densities_no_overflow():
    """Trained-scene densities (tau ~ 1e5 per slot): the packed composite
    stays finite and equals the dense per-ray composite of the JAX package
    (atol 1e-5)."""
    case = _packed_case(3, 3.3e6)
    dense = jops.composite_rays(*map(jnp.asarray, case['dense']), 1e-4)
    sig, rgb, dts, ts, pvalid, prid, soffs = case['packed']
    out = tops.composite_packed(_t(sig), _t(rgb), _t(dts), _t(ts),
                                _t(pvalid), _t(prid).long(),
                                _t(soffs).long(), case['Gr'], case['K'])
    for o, r in zip(out, dense):
        assert np.isfinite(o.numpy()).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_composite_inf_density_stays_finite():
    """tau = inf is capped at 60: finite outputs, the spike absorbs the
    rest of the ray, same values as the JAX composite (atol 1e-6)."""
    sig = np.array([[1.0, np.inf, 5.0, 2.0]], np.float32)
    rgb = np.full((1, 4, 3), 0.5, np.float32)
    dts = np.full((1, 4), 0.01, np.float32)
    ts = np.array([[0.5, 0.6, 0.7, 0.8]], np.float32)
    valid = np.ones((1, 4), bool)
    ref = jops.composite_rays(*map(jnp.asarray, (sig, rgb, dts, ts, valid)))
    out = tops.composite_rays(*map(_t, (sig, rgb, dts, ts, valid)))
    for o, r in zip(out, ref):
        assert np.isfinite(o.numpy()).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    assert abs(float(out[0][0]) - 1.0) < 1e-5


def test_packbits_and_occupied_aabb_match_jax():
    """Exact: bit order (bit i of byte b = element 8b + i) and the
    occupied box of a sparse grid."""
    rng = np.random.RandomState(5)
    H = 16
    grid = rng.rand(2, H ** 3).astype(np.float32)
    grid[1] = 0.0
    grid[1, (5 * H + 7) * H + 3] = 1.0
    ref = jops.packbits(jnp.asarray(grid), 0.9)
    out = tops.packbits(_t(grid), 0.9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tops.unpackbits(out).numpy(),
                                  np.asarray(jops.unpackbits(ref)))
    np.testing.assert_array_equal(
        tops.occupied_aabb(out, H, 1.0).numpy(),
        np.asarray(jmarch.occupied_aabb(ref, H, 1.0)))


def test_sh_encode_and_trunc_exp_match_jax():
    """SH degree 4 (atol 1e-6); trunc_exp's forward is unbounded and its
    gradient uses the exponent clamped at 15."""
    rng = np.random.RandomState(6)
    d = rng.randn(100, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tops.sh_encode(_t(d), 4).numpy(),
        np.asarray(jops.sh_encode(jnp.asarray(d), 4)), atol=1e-6)
    x = torch.tensor([0.5, 20.0, 100.0], requires_grad=True)
    y = tops.trunc_exp(x)
    assert torch.isinf(y[2]) and torch.isclose(y[1], torch.exp(x[1]))
    y[:2].sum().backward()
    jg = jax.grad(lambda v: jops.trunc_exp(v)[:2].sum())(
        jnp.asarray([0.5, 20.0, 100.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6)


def test_cam_rays_and_near_far_match_jax():
    """Rays of an orbit camera and their box intersection (atol 1e-6)."""
    import synthetic
    poses = np.stack([synthetic.look_at_pose(
        1.3 * np.array([np.cos(a), 0.3, np.sin(a)]))
        for a in (0.0, 1.0, 2.5)])[None]
    intr = np.array([[[131.25, 131.25, 64.0, 64.0]] * 3], np.float32)
    ro, rd = jops.get_cam_rays(jnp.asarray(poses), jnp.asarray(intr), 32, 24)
    to, td = tops.get_cam_rays(_t(poses), _t(intr), 32, 24)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), atol=1e-6)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jops.near_far_from_aabb(ro, rd, jnp.asarray(aabb), 0.2)
    tn, tf = tops.near_far_from_aabb(to, td, _t(aabb), 0.2)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)


def test_import_ssdnerf_torch_loads_no_jax():
    """The port must run where JAX is absent: importing it (and building a
    model) pulls in neither jax nor flax."""
    code = ('import sys, ssdnerf_torch; '
            'from ssdnerf_torch.models.autodecoders import DiffusionNeRF; '
            'bad = [m for m in ("jax", "flax", "ssdnerf_tpu") '
            'if m in sys.modules]; '
            'assert not bad, bad')
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
