"""The attention profiling tool's parts that need no card: its variant
still applies to the sources, its ptxas parsing, and its count of the
CTAs an SM holds."""
from ssdnerf_torch.ops.kernels import _build
from ssdnerf_torch.tools import attention_profile

FWD = ('_ZN12_GLOBAL__N_125attention_fwd_sm90_kernelILi40ELi3EEEv14CUtensor'
       'Map_stS1_S1_P13__nv_bfloat16PfS4_if')
LOG = f"""
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 152 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12other_kernelv' for 'sm_90a'
ptxas info    : Used 20 registers, 360 bytes cmem[0]
"""


def test_variants_apply_to_the_current_sources():
    """Each variant's edits find their text in today's sources."""
    codes = [(_build.CSRC / s).read_text() for s in attention_profile.SOURCES]
    for name, edits in attention_profile.VARIANTS.items():
        assert all(any(old in c for c in codes) for old, _ in edits), name


def test_kernel_resources_from_ptxas():
    """Registers, spills and static shared memory of the attention
    kernels; other kernels are left out."""
    assert attention_profile.kernel_resources(LOG) == {
        FWD: dict(registers=152, spill_bytes=12, static_smem=16)}


def test_ctas_per_sm():
    """The three-warpgroup forward (416 threads at 152 registers) fits
    once on an SM by its registers; a 288-thread CTA of 112 registers and
    82 KB fits twice, of 120 registers once; 120 KB of shared memory
    allows one."""
    per_sm = attention_profile.ctas_per_sm
    assert per_sm(152, 416, 91392) == 1
    assert per_sm(112, 288, 82176) == 2
    assert per_sm(120, 288, 82176) == 1
    assert per_sm(32, 128, 120000) == 1
