"""The bf16 attention kernels' device times on the card, by version.

Builds the attention sources of ``csrc/`` (``attention.cu``, whose C
entries ``attention_fwd_bf16`` / ``attention_bwd_bf16`` dispatch, and the
``wgmma`` kernels of ``attention_fwd_sm90.cu`` / ``attention_bwd_sm90.cu``)
into one library under ``build/variants/attention_<name>/``, once as they
are and once for each variant (a one-line edit of the sources), and times
each library's bf16 forward and backward at the UNet levels that run them
(G = 32 programs, (T, hd) = (1024, 64) and (768, 40)), in turns, beside
one ``scaled_dot_product_attention`` call and its backward.  Device ms
come from ``torch.profiler`` (the kernels' own durations over ``calls``
calls, summed by kernel), not from CUDA events around the calls, which a
host that enqueues slower than the kernels run would inflate.

* ``ptxas -v`` of each library: registers, spills and shared memory of
  each kernel, and from them the CTAs an SM holds (registers, shared
  memory and threads) and the waves each launch makes over the card's
  SMs;
* variant ``fwd_128_rows``: the forward with 128-row CTAs (two consumer
  warpgroups) at every length, where the sources take 192 (three) at T a
  multiple of 192.

    python -m ssdnerf_torch.tools.attention_profile \\
        [--csrc [LABEL=]DIR ...] [--out FILE] [--rounds N]

``--csrc``, repeatable, names the copies of the sources to time in turns
(by default the package's own, labelled ``tree``; a parent commit
unpacked under ``build/``, say, beside it: ``--csrc
parent=build/parent/ssdnerf_torch/csrc --csrc tree=ssdnerf_torch/csrc``).
A variant whose edit does not apply to a copy is reported as not
applicable.  The result is one JSON object, printed and written to
``--out``.
"""
import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import _build
from ..ops.kernels import attention as k_attn

SOURCES = ('attention.cu', 'attention_fwd_sm90.cu', 'attention_bwd_sm90.cu')
SHAPES = ((1024, 64), (768, 40))
G = 32
VARIANTS = {
    'fwd_128_rows': [('const bool three = T % 192 == 0;',
                      'const bool three = false;')],
}
REGS_PER_SM, SMEM_PER_SM, THREADS_PER_SM = 65536, 233472, 2048


def build_variant(src_dir, name, edits):
    """The attention sources of ``src_dir`` with ``edits`` applied, built
    into build/variants/attention_<name>/; (library path, ptxas log), or
    None when an edit does not apply."""
    codes = {s: (Path(src_dir) / s).read_text() for s in SOURCES}
    if not all(any(old in c for c in codes.values()) for old, _ in edits):
        return None
    out = _build.BUILD_DIR.parent / 'variants' / f'attention_{name}'
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for f in Path(src_dir).glob('*.cuh'):
        shutil.copy(f, out)
    for src, code in codes.items():
        for old, new in edits:
            code = code.replace(old, new)
        (out / src).write_text(code)
    lib = out / 'libattention.so'
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', str(lib), *(str(out / s) for s in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed for {name}:\n'
                           f'{proc.stdout}{proc.stderr}')
    return lib, proc.stdout + proc.stderr


def kernel_resources(log):
    """From a ptxas log, each attention kernel's registers, spill bytes
    and static shared memory, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if 'attention' in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out.setdefault(name, {})['spill_bytes'] = (int(m.group(1))
                                                       + int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            r = out.setdefault(name, {})
            r['registers'] = int(m.group(1))
            s = re.search(r'(\d+) bytes smem', line)
            r['static_smem'] = int(s.group(1)) if s else 0
    return out


def ctas_per_sm(registers, threads, smem):
    """CTAs an SM holds at ``registers`` a thread (allocated 8 at a time,
    by warp), ``threads`` a CTA and ``smem`` bytes of shared memory a CTA
    (plus the 1 KB the system reserves for each)."""
    warps = math.ceil(threads / 32)
    by_regs = REGS_PER_SM // (warps * 32 * math.ceil(registers / 8) * 8)
    by_smem = SMEM_PER_SM // (smem + 1024)
    return min(by_regs, by_smem, THREADS_PER_SM // threads)


def _entry(lib, name):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'{name}: CUDA error {err}')
    return call


def device_ms(call, calls=30):
    """Device ms of one call by kernel name: torch.profiler over ``calls``
    calls after a warm-up call; a kernel's count of events must be a
    multiple of ``calls`` (else the trace lost events, and is retaken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        ms, count = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms[e.name] = ms.get(e.name, 0.0) + (
                    e.time_range.elapsed_us() / (1e3 * calls))
                count[e.name] = count.get(e.name, 0) + 1
        if ms and all(c % calls == 0 for c in count.values()):
            return {re.sub(r'^(void )?(\(anonymous namespace\)::)?', '',
                           n).split('(')[0]: t for n, t in ms.items()}
    raise RuntimeError(f'device_ms: {count} events for {calls} calls')


def inputs(T, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((G, T, hd), generator=g).cuda().bfloat16()
                   for _ in range(4))
    return q, k, v, do


def time_library(lib, T, hd):
    """Device ms of library ``lib``'s bf16 forward (with lse and o32, as
    under autograd) and backward at (G, T, hd), by kernel."""
    fwd, bwd = (_entry(lib, n) for n in ('attention_fwd_bf16',
                                         'attention_bwd_bf16'))
    q, k, v, do = inputs(T, hd)
    scale = 1.0 / math.sqrt(hd)
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    o32 = torch.empty_like(q, dtype=torch.float32)
    lse, D = (torch.empty((G, T), dtype=torch.float32, device=q.device)
              for _ in range(2))
    p = [t.data_ptr() for t in (q, k, v, o, o32, lse)]
    run_fwd = lambda: fwd(*p, G, T, hd, scale)  # noqa: E731
    run_bwd = lambda: bwd(  # noqa: E731
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), D.data_ptr(), G, T, hd, scale)
    run_fwd()
    ref = k_attn.attention_plain(q, k, v, scale)
    ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    err = ((o.float() - ref.float()).abs().max() / ulp).item()
    return dict(forward=device_ms(run_fwd), backward=device_ms(run_bwd),
                forward_err_ulps=err)


def time_sdpa(T, hd):
    """Device ms of one bf16 scaled_dot_product_attention call and of its
    backward at (G, T, hd), by kernel (as (G, 1, T, hd): on 3-D operands
    the library takes its composite path, not its flash kernels)."""
    q, k, v, do = (t[:, None] for t in inputs(T, hd))  # (G, 1, T, hd)
    scale = 1.0 / math.sqrt(hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, scale=scale)
    return dict(forward=device_ms(lambda: sdpa(q, k, v, scale=scale)),
                backward=device_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True)))


def launches(T, hd, resources, sms, fwd_rows):
    """CTAs, CTAs an SM holds and waves over ``sms`` SMs of each wgmma
    kernel the sources launch at (G, T, hd), the forward's CTAs holding
    ``fwd_rows`` query rows, from their ptxas resources (the dynamic
    shared memory as the sources size it)."""
    out = {}
    for name, r in resources.items():
        m = re.search(r'attention_(fwd|bwd_dq|bwd_dkdv)_sm90_kernelILi(\d+)'
                      r'(?:ELi(\d+))?', name)
        if not m or int(m.group(2)) != hd:
            continue
        if m.group(1) == 'fwd':
            nc = int(m.group(3))
            if 64 * nc != fwd_rows:
                continue
            rows, threads = 64 * nc, 128 * nc + 32
            smem = 1024 + rows * 128 + 2 * 4 * 8192 + 256
        else:
            rows, threads = 128, 384
            smem = 1024 + 4 * 8192 + 2 * 4 * 8192 + 256 + (
                2 * 4 * 256 if m.group(1) == 'bwd_dkdv' else 0)
        ctas = G * T // rows
        per_sm = ctas_per_sm(r['registers'], threads, smem)
        out[m.group(1)] = dict(kernel=name, ctas=ctas, rows=rows,
                               threads=threads, dynamic_smem=smem,
                               ctas_per_sm=per_sm,
                               waves=ctas / (per_sm * sms))
    return out


def run(csrcs, rounds=2):
    """Build each source copy of ``csrcs`` (label -> directory) and its
    variants, and time them all in turns, ``rounds`` times (the order,
    then the order reversed); the library of label L and variant V is
    named "L" or "L:V"."""
    jobs = [(f'{label}' + ('' if v is None else f':{v}'), path,
             [] if v is None else VARIANTS[v])
            for label, path in csrcs.items() for v in (None, *VARIANTS)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip((n for n, _, _ in jobs), pool.map(
            lambda j: build_variant(j[1], j[0].replace(':', '_'), j[2]),
            jobs)))
    libs = {n: b for n, b in built.items() if b is not None}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = list(libs) + list(libs)[::-1]
    rows = {f'{T}x{hd}': dict(times={n: [] for n in libs})
            for T, hd in SHAPES}
    for _ in range(rounds):
        for n in order:
            for T, hd in SHAPES:
                rows[f'{T}x{hd}']['times'][n].append(
                    time_library(libs[n][0], T, hd))
    for T, hd in SHAPES:
        row = rows[f'{T}x{hd}']
        row['sdpa'] = time_sdpa(T, hd)
        row['launch'] = {
            n: launches(T, hd, kernel_resources(b[1]), sms,
                        128 if n.endswith(':fwd_128_rows') or T % 192
                        else 192)
            for n, b in libs.items()}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    return dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                sms=sms, csrc={k: str(v) for k, v in csrcs.items()}, G=G,
                resources={n: kernel_resources(b[1])
                           for n, b in libs.items()},
                not_applicable=[n for n, b in built.items() if b is None],
                rows=rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--csrc', action='append', default=None,
                    help='[LABEL=]DIR, repeatable (default: tree=the '
                    "package's csrc)")
    ap.add_argument('--out', default=None)
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('attention_profile needs a CUDA card')
    csrcs = {}
    for i, spec in enumerate(args.csrc or [f'tree={_build.CSRC}']):
        label, _, path = spec.rpartition('=')
        csrcs[label or f'csrc{i}'] = Path(path).resolve()
    res = run(csrcs, args.rounds)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)


if __name__ == '__main__':
    main()
