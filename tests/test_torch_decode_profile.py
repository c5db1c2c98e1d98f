"""The decode profiling tool's parts that need no card: its one-line
variants still apply to ``csrc/decode.cu``, its SASS loop counting and its
reading of ptxas's registers and spills, for every decode kernel."""
from ssdnerf_torch.ops.kernels import _build
from ssdnerf_torch.tools import decode_profile

SASS = """
        code for sm_90a
                Function : _Z26triplane_decode_bwd_kernelILi6ELi64EEvPKf
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x0 */
        /*0010*/                   LDS.128 R4, [R2] ;            /* 0x0 */
        /*0020*/                   HMMA.1688.F32.TF32 R8, R4, R6, R8 ;
        /*0030*/                   FFMA R9, R4, R5, R9 ;         /* 0x0 */
        /*0040*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU [R2], R9 ;
        /*0050*/              @P0  BRA 0x10 ;                    /* 0x0 */
        /*0060*/                   LDG.E R3, desc[UR4][R2.64] ;  /* 0x0 */
        /*0070*/                   EXIT ;                        /* 0x0 */
                Function : _Z10other_kernelv
        /*0000*/                   FFMA R1, R1, R1, R1 ;         /* 0x0 */
"""


def test_variants_apply_to_the_current_source():
    """Each variant has an edit list whose old texts are all in today's
    decode.cu, so the tool still splits the backward's time."""
    code = (_build.CSRC / 'decode.cu').read_text()
    for name, alternatives in decode_profile.VARIANTS.items():
        assert any(all(old in code for old, _ in edits)
                   for edits in alternatives), name


def test_sass_loop_counts():
    """One loop (0x10-0x50) of the decode backward, its instruction
    classes counted; functions of other kernels are left out."""
    counts = decode_profile.parse_sass(SASS)
    assert list(counts) == ['_Z26triplane_decode_bwd_kernelILi6ELi64EEvPKf']
    (fn,) = counts.values()
    assert fn['loops'] == [dict(range='0x10-0x50', LDS=1, FFMA=1, HMMA=1,
                                **{'RED/ATOM': 1}, LDG=0, total=5)]
    assert fn['whole'] == dict(LDS=1, FFMA=1, HMMA=1, **{'RED/ATOM': 1},
                               LDG=1, total=8)


FUNC = ('_ZN12_GLOBAL__N_1{n}{name}ILi6ELi64ELb{b}EEEvPKN3cuda3std3__4'
        '11conditionalIXT1_E13__nv_bfloat16fE4typeEPKfPKiSB_SB_')
NAMES = ('triplane_decode_kernel', 'triplane_decode_composite_kernel',
         'triplane_decode_banded_kernel')


def _func(name, b=0):
    return FUNC.format(n=len(name), name=name, b=b)


def test_sass_counts_every_forward_kernel():
    """The split forward, the fused decode + composite and the banded
    decode are all counted (the last two share the forward's machinery),
    each apart from the others."""
    text = ''.join(f"""
                Function : {_func(n)}
        /*0000*/                   HMMA.1688.F32.TF32 R8, R4, R6, R8 ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/              @P0  BRA 0x0 ;
        /*0030*/                   EXIT ;
""" for n in NAMES)
    counts = decode_profile.parse_sass(text)
    assert sorted(counts) == sorted(_func(n) for n in NAMES)
    for fn in counts.values():
        assert fn['loops'] == [dict(range='0x0-0x20', LDS=1, FFMA=0, HMMA=1,
                                    **{'RED/ATOM': 0}, LDG=0, total=3)]


def test_ptxas_usage_reads_registers_and_spills():
    """Registers and spill bytes of each decode kernel of a ``ptxas -v``
    log, in both modes; other kernels are left out."""
    lines = []
    for i, n in enumerate(NAMES):
        for b in (0, 1):
            f = _func(n, b)
            lines += [
                f"ptxas info    : Compiling entry function '{f}' for "
                "'sm_90a'",
                f'ptxas info    : Function properties for {f}',
                f'    0 bytes stack frame, {8 * b} bytes spill stores, '
                f'{4 * b} bytes spill loads',
                f'ptxas info    : Used {100 + i} registers, used 1 barriers',
            ]
    lines += ["ptxas info    : Compiling entry function '_Z5otherv' for "
              "'sm_90a'", 'ptxas info    : Used 8 registers']
    usage = decode_profile.ptxas_usage('\n'.join(lines))
    assert len(usage) == 6
    for i, n in enumerate(NAMES):
        for b in (0, 1):
            assert usage[_func(n, b)] == dict(
                registers=100 + i, spill_stores=8 * b, spill_loads=4 * b)


def test_full_build_lists_every_decode_source():
    """The tool's full build compiles every decode source of the package
    (a source missing from the list would go untimed)."""
    have = {p.name for p in _build.CSRC.glob('decode*.cu')}
    assert set(decode_profile.DECODE_SOURCES) == have
