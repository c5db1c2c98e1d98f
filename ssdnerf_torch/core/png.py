"""PNG reading and writing with the standard library and numpy.

``read_png`` gives what ``cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]``
gives for a non-interlaced PNG: 8-bit RGB rows of any colour type (gray,
gray + alpha, RGB, RGBA, palette) and bit depth (1-16), palette and gray
expanded, 16-bit samples narrowed to their high byte, alpha dropped
without compositing.  ``zlib`` inflates the image data; the row filters
are undone by ``png_unfilter.c``, compiled on first use into ``build/png/``
at the repository root with the host C compiler (``cc`` or ``gcc``, which
``nvcc`` needs as well); ``read_pngs`` decodes a list of files on
threads.

``write_png`` writes 8- or 16-bit gray, RGB or RGBA images, and
``imsave_viridis`` a 2-D array through matplotlib's default colormap over
``vmin..vmax`` as ``matplotlib.pyplot.imsave`` bins it (the 256-entry
viridis table of matplotlib, CC0, is carried below).
"""
import base64
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_SRC = Path(__file__).resolve().with_name('png_unfilter.c')
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'png'
_lock = threading.Lock()
_lib = []


def _compile_cmd(out):
    """The host C compiler's command building ``png_unfilter.c`` into the
    shared library ``out``."""
    cc = shutil.which('cc') or shutil.which('gcc')
    if cc is None:
        raise RuntimeError('reading PNGs needs a C compiler (cc or gcc) to '
                           'build png_unfilter.c')
    return [cc, '-O2', '-shared', '-fPIC', '-o', str(out), str(_SRC)]


def _unfilter_lib():
    """The compiled row unfilter (built once per source version)."""
    with _lock:
        if not _lib:
            digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
            so = BUILD_DIR / f'png_unfilter_{digest}.so'
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
                subprocess.run(_compile_cmd(tmp), check=True,
                               capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
            _lib.append(lib)
    return _lib[0]


def _chunks(buf):
    if buf[:8] != _SIGNATURE:
        raise ValueError('not a PNG file')
    pos = 8
    while pos + 12 <= len(buf):
        n, kind = struct.unpack('>I4s', buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) != crc or len(data) != n:
            raise ValueError(f'PNG chunk {kind!r}: bad CRC or truncated')
        yield kind, data
        if kind == b'IEND':
            return
        pos += 12 + n
    raise ValueError('PNG file ends before IEND')


def decode_png(buf):
    """PNG bytes -> (H, W, 3) uint8 RGB (see the module docstring)."""
    idat, plte, header = [], None, None
    for kind, data in _chunks(buf):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', data)
        elif kind == b'PLTE':
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(data)
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise NotImplementedError('interlaced PNG')
    ch = _CHANNELS[color]
    bits = ch * depth
    rowbytes = (w * bits + 7) // 8
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != h * (rowbytes + 1):
        raise ValueError('PNG image data of the wrong size')
    src = np.frombuffer(raw, np.uint8)
    rows = np.empty((h, rowbytes), np.uint8)
    bad = _unfilter_lib().png_unfilter(src.ctypes.data, rows.ctypes.data, h,
                                       rowbytes, max(1, bits // 8))
    if bad:
        raise ValueError(f'PNG row {bad - 1}: unknown filter type')
    if depth == 16:
        samples = rows.reshape(h, w * ch, 2)[..., 0]     # high bytes
    elif depth < 8:
        samples = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        samples = samples @ (1 << np.arange(depth - 1, -1, -1)).astype(
            np.uint8)
        samples = samples[:, :w]
        if color == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    else:
        samples = rows
    samples = samples.reshape(h, w, ch)
    if color == 3:
        return plte[samples[..., 0]]
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def read_png(path):
    """(H, W, 3) uint8 RGB of the PNG file at ``path``."""
    with open(path, 'rb') as f:
        return decode_png(f.read())


def read_pngs(paths, num_threads=8):
    """(N, H, W, 3) uint8 of same-sized PNG files, decoded on threads."""
    if num_threads <= 1 or len(paths) <= 1:
        return np.stack([read_png(p) for p in paths])
    with ThreadPoolExecutor(min(num_threads, len(paths))) as pool:
        return np.stack(list(pool.map(read_png, paths)))


# ------------------------------------------------------------- writing
def _filter_rows(rows, bpp, filters):
    """Filter (h, rowbytes) uint8 rows with one filter type a row."""
    h, n = rows.shape
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    filters = np.broadcast_to(np.asarray(filters), (h,))
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = filters
    for ft in np.unique(filters):
        rows = filters == ft
        out[rows, 1:] = (x[rows] - preds[ft][rows]).astype(np.uint8)
    return out


def _chunk(kind, data):
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def encode_raw(rows, width, depth, color, filters=4, palette=None):
    """PNG bytes of packed rows (h, rowbytes) uint8 of colour type
    ``color`` and bit ``depth``, each row filtered with ``filters`` (one
    type for all rows, or one a row), deflated at zlib's level 6."""
    h = rows.shape[0]
    bpp = max(1, _CHANNELS[color] * depth // 8)
    body = _chunk(b'IHDR', struct.pack('>IIBBBBB', width, h, depth, color,
                                       0, 0, 0))
    if palette is not None:
        body += _chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    body += _chunk(b'IDAT', zlib.compress(
        _filter_rows(rows, bpp, filters).tobytes(), 6))
    return _SIGNATURE + body + _chunk(b'IEND', b'')


def encode_png(img, filters=4):
    """PNG bytes of an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image
    of uint8 or uint16 samples (Paeth-filtered rows by default)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[ch]
    if img.dtype == np.uint16:
        rows = img.astype('>u2').view(np.uint8).reshape(h, -1)
        return encode_raw(rows, w, 16, color, filters)
    if img.dtype != np.uint8:
        raise TypeError(f'PNG samples must be uint8 or uint16, not '
                        f'{img.dtype}')
    return encode_raw(img.reshape(h, w * ch), w, 8, color, filters)


def write_png(path, img):
    """Write ``img`` (see :func:`encode_png`) to ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_png(img))


def write_pngs(paths, imgs, num_threads=8):
    """:func:`write_png` of each image to its path, on threads (zlib
    releases the GIL)."""
    with ThreadPoolExecutor(num_threads) as pool:
        list(pool.map(write_png, paths, imgs))


_VIRIDIS = np.frombuffer(base64.b64decode(
    'RAFURAJVRANXRQVYRQZaRQhbRglcRgteRgxfRg5hRw9iRxFjRxJlRxRmRxVnRxZpRxhqSBlr'
    'SBpsSBxuSB1vSB5wSCBxSCFySCJzSCN0RyV1RyZ2Ryd3Ryh4Ryp5Ryt6Ryx7Ri18Ri98RjB9'
    'RjF+RTJ/RTR/RTWARTaBRDeBRDmCQzqDQzuDQzyEQj2EQj6FQkCFQUGGQUKGQEOHQESHP0WH'
    'P0eIPkiIPkmJPUqJPUuJPUyJPE2KPE6KO1CKO1GKOlKLOlOLOVSLOVWLOFaLOFeMN1iMN1mM'
    'NlqMNluMNVyMNV2MNF6NNF+NM2CNM2GNMmKNMmONMWSNMWWNMWaNMGeNMGiNL2mNL2qNLmuO'
    'LmyOLm2OLW6OLW+OLHCOLHGOLHKOK3OOK3SOKnWOKnaOKneOKXiOKXmOKHqOKHqOKHuOJ3yO'
    'J32OJ36OJn+OJoCOJoGOJYKOJYONJISNJIWNJIaNI4eNI4iNI4mNIomNIoqNIouNIYyNIY2M'
    'IY6MII+MIJCMIJGMH5KMH5OLH5SLH5WLH5aLHpeKHpiKHpmKHpmKHpqJHpuJHpyJHp2IHp6I'
    'Hp+IHqCHH6GHH6KGH6OGIKSFIKWFIaaFIaeEIqeEI6iDI6mCJKqCJauBJqyBJ62AKK5/Ka9/'
    'KrB+K7F9LLF9LrJ8L7N7MLR6MrV6M7Z5Nbd4Nrh3OLl2Obl2O7p1Pbt0PrxzQL1yQr5xRL5w'
    'Rb9vR8BuScFtS8JsTcJrT8NpUcRoU8VnVcZmV8ZlWcdkW8hiXslhYMlgYspfZMtdZ8xcacxb'
    'a81Zbc5YcM5Wcs9VdNBUd9BSedFRfNJPftJOgdNMg9NLhtRJiNVHi9VGjdZEkNZDktdBldc/'
    'l9g+mtg8ndk6n9k4oto3pdo1p9szqtsyrdwwr9wust0std0rt90put4nvd4mv98kwt8ixd8h'
    'x+AfyuAezeAdz+Ec0uEb1OEa1+IZ2uIY3OIY3+MY4eMY5OMY5+QZ6eQZ7OQa7uUb8eUc8+Ue'
    '9uYf+OYh+uYi/eck'), np.uint8).reshape(256, 3)


def imsave_viridis(path, arr, vmin, vmax):
    """``matplotlib.pyplot.imsave(path, arr, vmin=vmin, vmax=vmax)`` of a
    2-D float array, written as an RGB PNG: ``Normalize`` in the array's
    float type, 256 bins, values below ``vmin`` / above ``vmax`` the end
    colours, NaN black."""
    arr = np.asarray(arr)
    dt = np.float32 if arr.dtype == np.float32 else np.float64
    x = (arr.astype(np.float64) - vmin).astype(dt)
    x = (x.astype(np.float64) / (vmax - vmin)).astype(dt) * dt(256)
    x[x == 256] = 255
    with np.errstate(invalid='ignore'):
        idx = np.clip(np.nan_to_num(x, nan=0.0), -1, 256).astype(int)
    rgb = _VIRIDIS[np.where(x < 0, 0, np.where(x >= 256, 255, idx))]
    rgb[np.isnan(x)] = 0
    write_png(path, rgb)
