"""attention_fwd_roofline.sample: the bf16 ``wgmma`` attention forward's
share (%) of its roofline: the least time of the attention calls it runs
(the UNet's bf16 levels, counted from the shapes by
``benchmark/counts/unet.py``, one set a forward) over the device time of
its kernels in the trace.  Moves ``sample_scenes_per_s``."""
from benchmark.counts import unet

KERNEL = 'attention_fwd_sm90_kernel'


def read(r):
    if r.trace is None:
        return None
    forwards = r.trace.range_count('benchmark.unet')
    seconds = r.trace.device_seconds(lambda n: KERNEL in n)
    if not forwards or seconds <= 0:
        return None
    res = r.result
    den = res['spec']['model']['diffusion']['denoising']
    calls = [w for _, dtype, w in unet.attention_calls(den, res['scenes'])
             if dtype == 'torch.bfloat16']
    bound = sum(w.bound_s() for w in calls) * forwards
    return 100.0 * bound / seconds
