"""The decode profiling tool's parts that need no card: its one-line
variants still apply to ``csrc/decode.cu``, and its SASS loop counting."""
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
