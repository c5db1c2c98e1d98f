"""mfu.train: the training iteration's share (%) of the card's peak: the
least time of its counted work (``benchmark/counts``: the UNet's forward
and backward at the batch, the diffusion Adam step's and the EMA's bytes)
over the window's wall time.  The render's work is left out (under 1% of
the UNet's), so this is a lower bound.  Moves ``train_step_ms``."""
from benchmark.counts import Work, unet

ADAM_BYTES = 7 * 4      # a parameter read and written, its gradient read,
                        # both moments read and written (f32)
EMA_BYTES = 3 * 4       # the EMA read and written, the live one read


def read(r):
    res = r.result
    if not res['iterations'] or res['wall_s'] <= 0:
        return None
    spec = res['spec']
    den = spec['model']['diffusion']['denoising']
    step = 3 * unet.forward_bound_s(den, res['batch'])
    step += Work(bytes=res['params'] * (ADAM_BYTES + EMA_BYTES)).bound_s()
    return 100.0 * step * res['iterations'] / res['wall_s']
