"""decode_fwd_roofline.view: the bf16 decode kernel's share (%) of its
roofline over the window: the least time of the samples the frames
composite (the benchmark's own march and compaction of every frame,
``benchmark/counts/render.py``; ``counts/decode.py``'s work a sample, the
planes and the rays' direction outputs read once a frame) over the
kernel's device time in the trace.  Moves ``view_p95_ms``."""
from benchmark.counts import decode

KERNEL = 'triplane_decode_kernel'


def read(r):
    res = r.result
    if r.trace is None or res.get('counts') is None:
        return None
    seconds = r.trace.device_seconds(lambda n: KERNEL in n)
    if seconds <= 0:
        return None
    dec = res['spec']['model']['decoder']
    C = dec['base_layers'][0] // 3
    hidden = dec['base_layers'][1]
    res_px = res['spec']['model']['code_size'][-1]
    rays = res['size'] ** 2
    work = decode.forward(res['counts'][0], 0, C, hidden, res_px, True)
    per_frame = decode.forward(0, rays, C, hidden, res_px, True).bytes
    work.bytes += (res['frames'] - 1) * per_frame
    return 100.0 * work.bound_s() / seconds
