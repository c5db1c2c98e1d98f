"""mfu.view: the frames' share (%) of the card's peak: the least time of
their counted work (the march's lookups and the decode of the samples the
frames composite, ``benchmark/counts``) over the window's wall time.  The
composite and the glue are left out, so this is a lower bound.  Moves
``view_p95_ms``."""
from benchmark.counts import decode, march


def read(r):
    res = r.result
    if r.trace is None or res.get('counts') is None or res['wall_s'] <= 0:
        return None
    spec = res['spec']['model']
    dec = spec['decoder']
    C, hidden = dec['base_layers'][0] // 3, dec['base_layers'][1]
    rays = res['size'] ** 2 * res['frames']
    bound = decode.forward(res['counts'][0], rays, C, hidden,
                           spec['code_size'][-1], True).bound_s()
    bound += march.occupancy(res['counts'][1], spec['grid_size'],
                             res['frames']).bound_s()
    return 100.0 * bound / res['wall_s']
