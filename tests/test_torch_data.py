"""The port's PNG code and SRN dataset vs the JAX package's data path on
the CPU.

- ``core.png.read_png`` against ``cv2.imread(IMREAD_COLOR)[..., ::-1]``
  (what the JAX loader and its ``pngdec.c`` give) on PNGs of every colour
  type and bit depth, each row with one of the five filters (exact), and
  its C unfilter against a byte-by-byte Python loop of the specification;
- the writer read back by cv2, and the viridis triplane dump against
  ``matplotlib.pyplot.imsave`` (exact);
- ``ShapeNetSRN`` and ``collate`` against the JAX package's on a directory
  written by ``tools/make_synthetic_srn.py``, with the ``val_uncond`` and
  ``val_cond`` arguments of configs/paper_cfgs/ssdnerf_cars_uncond.py and
  ssdnerf_cars_recons1v.py, the scene-list cache, ``code_dir`` and
  ``test_pose_override`` (every array exact).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from ssdnerf_tpu.data.builder import collate as jax_collate
from ssdnerf_tpu.data.shapenet_srn import ShapeNetSRN as JaxShapeNetSRN
from ssdnerf_torch.core import png
from ssdnerf_torch.data import ShapeNetSRN, build_dataset, collate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cv2():
    return pytest.importorskip('cv2', reason='cv2 is not installed')


def _pack(vals, depth):
    """(h, w * ch) samples of ``depth`` bits -> packed (h, rowbytes)."""
    if depth == 16:
        return vals.astype('>u2').view(np.uint8).reshape(vals.shape[0], -1)
    if depth == 8:
        return vals.astype(np.uint8)
    bits = np.unpackbits(vals.astype(np.uint8)[..., None], axis=-1)
    bits = bits[..., 8 - depth:].reshape(vals.shape[0], -1)
    return np.packbits(bits, axis=1)


# colour type, bit depth
VARIANTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
            (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
            (6, 16)]


@pytest.mark.parametrize('color,depth', VARIANTS)
def test_read_png_matches_cv2(tmp_path, color, depth):
    """Every colour type at each of its bit depths, 23 x 37 (rows of odd
    byte counts), the rows' filters cycling through all five in a random
    order: the port's reader gives cv2's RGB bytes exactly (palette and
    gray expanded, 16 bits narrowed, alpha dropped)."""
    cv2 = _cv2()
    rng = np.random.RandomState(100 + color * 17 + depth)
    h, w = 23, 37
    ch = png._CHANNELS[color]
    vals = rng.randint(0, 1 << depth, (h, w * ch))
    palette = rng.randint(0, 256, (1 << depth, 3)) if color == 3 else None
    filters = rng.permutation(np.arange(h) % 5)
    data = png.encode_raw(_pack(vals, depth), w, depth, color, filters,
                          palette)
    path = str(tmp_path / 'img.png')
    with open(path, 'wb') as f:
        f.write(data)
    got = png.read_png(path)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, ref)


def _unfilter_reference(raw, h, rowbytes, bpp):
    """The PNG specification's unfilter, one byte at a time."""
    out = np.zeros((h, rowbytes), np.int64)
    for y in range(h):
        line = raw[y * (rowbytes + 1):(y + 1) * (rowbytes + 1)]
        ft = line[0]
        for i in range(rowbytes):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if y and i >= bpp else 0
            if ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[ft]
            out[y, i] = (int(line[1 + i]) + int(pred)) % 256
    return out.astype(np.uint8)


def test_unfilter_matches_reference_loop():
    """The compiled unfilter against the loop above on random filtered
    bytes (every filter type, bpp 1, 3, 8): exact.  An unknown filter
    type raises."""
    import zlib
    rng = np.random.RandomState(101)
    for bpp, rowbytes in ((1, 13), (3, 30), (8, 64)):
        h = 12
        raw = rng.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
        raw[:, 0] = np.arange(h) % 5
        dst = np.empty((h, rowbytes), np.uint8)
        assert png._unfilter_lib().png_unfilter(
            raw.ctypes.data, dst.ctypes.data, h, rowbytes, bpp) == 0
        np.testing.assert_array_equal(
            dst, _unfilter_reference(raw.reshape(-1), h, rowbytes, bpp))
    bad = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    idat = bad.index(b'IDAT')
    n = int.from_bytes(bad[idat - 4:idat], 'big')
    rows = bytearray(zlib.decompress(bad[idat + 4:idat + 4 + n]))
    rows[0] = 7
    body = b'IDAT' + zlib.compress(bytes(rows))
    crc = zlib.crc32(body).to_bytes(4, 'big')
    forged = (bad[:idat - 4] + (len(body) - 4).to_bytes(4, 'big') + body
              + crc + bad[idat + 8 + n:])
    with pytest.raises(ValueError, match='unknown filter'):
        png.decode_png(forged)


@pytest.mark.parametrize('shape,dtype', [((20, 30, 3), np.uint8),
                                         ((20, 30, 4), np.uint8),
                                         ((20, 30), np.uint8),
                                         ((20, 30, 3), np.uint16)])
def test_write_png_read_back_by_cv2(tmp_path, shape, dtype):
    """``write_png`` (Paeth rows) of RGB, RGBA, gray and 16-bit images as
    cv2 reads them with IMREAD_UNCHANGED: the same samples."""
    cv2 = _cv2()
    rng = np.random.RandomState(102)
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / 'w.png')
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        back = back[..., [2, 1, 0, 3][:shape[2]]]
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read_png(path)[..., 0],
                                  (img[..., 0] if img.ndim == 3 else img)
                                  >> (8 if dtype == np.uint16 else 0))


def test_triplane_dump_matches_matplotlib(tmp_path):
    """``visualize_triplane`` against the JAX package's (``plt.imsave`` of
    viridis over the clip range) on codes that cross both ends of the
    range and hit its bin edges: identical pixels; matplotlib's alpha is
    opaque everywhere."""
    pytest.importorskip('matplotlib', reason='matplotlib is not installed')
    cv2 = _cv2()
    from ssdnerf_tpu.apis.eval_utils import (
        visualize_triplane as jax_visualize_triplane)
    from ssdnerf_torch.apis.eval_utils import visualize_triplane
    rng = np.random.RandomState(103)
    code = (rng.randn(2, 3, 4, 8, 8) * 1.5).astype(np.float32)
    code.reshape(-1)[:5] = [-2, 2, 0, 2 - 2 ** -22, -2 + 1 / 128]
    jax_visualize_triplane(code, ['a', 'b'], str(tmp_path / 'jax'),
                           code_range=(-2, 2))
    visualize_triplane(code, ['a', 'b'], str(tmp_path / 'port'),
                       code_range=(-2, 2))
    for name in ('a', 'b'):
        ref = cv2.imread(str(tmp_path / 'jax' / f'scene_{name}.png'),
                         cv2.IMREAD_UNCHANGED)
        got = png.read_png(str(tmp_path / 'port' / f'scene_{name}.png'))
        assert got.shape == (24, 32, 3)
        assert (ref[..., 3] == 255).all()
        np.testing.assert_array_equal(got, ref[..., 2::-1])


# ------------------------------------------------------------ dataset
@pytest.fixture(scope='module')
def srn_dir(tmp_path_factory):
    """4 synthetic sphere scenes x 9 views of 16x16 from
    ``tools/make_synthetic_srn.py`` (cv2-written PNGs)."""
    _cv2()
    out = tmp_path_factory.mktemp('srn')
    subprocess.run([sys.executable, os.path.join(ROOT, 'tools',
                                                 'make_synthetic_srn.py'),
                    str(out), '--scenes', '4', '--views', '9', '--size',
                    '16'], check=True, capture_output=True)
    return str(out)


def _assert_same(got, ref, what):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            _assert_same(g, r, f'{what}/{k}')
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, (what, k)
            np.testing.assert_array_equal(g, r, err_msg=f'{what}/{k}')
        else:
            assert g == r, (what, k)


# the test datasets' arguments of the two paper configs
UNCOND = dict(load_imgs=False, num_test_imgs=9, scene_id_as_name=True)
COND = dict(specific_observation_idcs=[4])


@pytest.mark.parametrize('args', [UNCOND, COND, dict(num_test_imgs=3)],
                         ids=['val_uncond', 'val_cond', 'split'])
def test_shapenet_srn_matches_jax(srn_dir, tmp_path, args):
    """``ShapeNetSRN`` items and their ``collate`` against the JAX
    package's (names, poses, intrinsics, images, paths: exact), both
    datasets built from the same scene-list cache file, which the port
    writes and the JAX dataset reads."""
    cache = str(tmp_path / 'cache.pkl')
    port = build_dataset(dict(type='ShapeNetSRN', data_prefix=srn_dir,
                              cache_path=cache, **args))
    assert os.path.exists(cache)
    ref = JaxShapeNetSRN(data_prefix=srn_dir, cache_path=cache, **args)
    assert len(port) == len(ref) == 4
    items = [port[i] for i in range(4)]
    for i in range(4):
        _assert_same(items[i], ref[i], f'scene {i}')
    _assert_same(collate(items), jax_collate([ref[i] for i in range(4)]),
                 'collate')
    if args is COND:
        assert items[0]['cond_imgs'].shape == (1, 16, 16, 3)
        assert items[0]['test_imgs'].shape == (8, 16, 16, 3)


def test_shapenet_srn_codes_and_pose_override_match_jax(srn_dir, tmp_path):
    """``code_dir`` (.npz scene states, collated as dicts),
    ``test_pose_override``, ``max_num_scenes`` / ``step`` and
    ``cache_decoded`` against the JAX package: exact."""
    code_dir = tmp_path / 'codes'
    code_dir.mkdir()
    rng = np.random.RandomState(104)
    names = sorted(os.listdir(srn_dir))
    for name in names:
        np.savez(str(code_dir / f'{name}.npz'), scene_name=name,
                 code=rng.randn(3, 2, 4, 4).astype(np.float32),
                 density_grid=rng.rand(64).astype(np.float16),
                 density_bitfield=rng.randint(0, 255, 8).astype(np.uint8))
    args = dict(code_dir=str(code_dir), test_pose_override=os.path.join(
        srn_dir, names[1]), max_num_scenes=2, step=2, num_test_imgs=2)
    port = ShapeNetSRN(data_prefix=srn_dir, cache_decoded=True, **args)
    ref = JaxShapeNetSRN(data_prefix=srn_dir, **args)
    assert len(port) == len(ref) == 2
    items = [port[i] for i in range(2)]
    for i in range(2):
        _assert_same(items[i], ref[i], f'scene {i}')
        _assert_same(port[i], ref[i], f'scene {i} cached')
    _assert_same(collate(items), jax_collate([ref[i] for i in range(2)]),
                 'collate')
    assert items[0]['test_poses'].shape == (9, 4, 4)
