"""mfu.sample: generation's share (%) of the card's peak: the least time
of its counted work (every UNet forward of the chains,
``benchmark/counts/unet.py``, and the density rebuilds' decodes,
``counts/decode.py``) over the window's wall time.  Moves
``sample_scenes_per_s``."""
from benchmark.counts import decode, unet


def read(r):
    res = r.result
    if not res['batches'] or res['wall_s'] <= 0:
        return None
    spec = res['spec']['model']
    den = spec['diffusion']['denoising']
    S = res['scenes']
    forward = unet.forward_bound_s(den, S)
    dec = spec['decoder']
    points = S * res['sweeps'] * spec['grid_size'] ** 3
    rebuild = decode.forward(points, 0, dec['base_layers'][0] // 3,
                             dec['base_layers'][1], spec['code_size'][-1],
                             True, colour=False).bound_s()
    bound = (res['steps'] * forward + rebuild) * res['batches']
    return 100.0 * bound / res['wall_s']
