"""The SASS reader that chip_smoke.py uses to count K2's compression loop,
on a hand-written listing in ``cuobjdump -sass``'s format (the toolkit is
not needed)."""

from pbs_plus_tpu_torch.ops import sass

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113sha256_kernelEPKhPKlS3_lPjj
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R2, desc[UR4][R4.64] ;
        /*0020*/                   SHF.R.W.U32 R3, R2, 0x7, R2 ;
        /*0030*/                   SHF.R.U32.HI R6, RZ, 0x3, R2 ;
        /*0040*/               @P0 BRA 0x20 ;
        /*0050*/                   LDS.128 R8, [R0] ;
        /*0060*/                   SHF.R.W.U32 R3, R2, 0x6, R2 ;
        /*0070*/                   SHF.R.W.U32 R5, R2, 0xb, R2 ;
        /*0080*/                   LOP3.LUT R3, R3, R5, R7, 0x96, !PT ;
        /*0090*/                   IMAD R4, R3, R9, R4 ;
        /*00a0*/              @!P1 BRA 0x50 ;
        /*00b0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_121candidate_mask_kernelEv
        /*0000*/                   SHF.R.W.U32 R3, R2, 0x6, R2 ;
        /*0010*/                   SHF.R.W.U32 R3, R2, 0x6, R2 ;
        /*0020*/                   SHF.R.W.U32 R3, R2, 0x6, R2 ;
        /*0030*/                   BRA 0x0 ;
"""


def test_functions_and_loops():
    fns = sass.functions(LISTING)
    assert [len(v) for v in fns.values()] == [12, 4]
    sha = next(v for k, v in fns.items() if "sha256_kernel" in k)
    bodies = sass.loops(sha)
    assert [sum(b.values()) for b in bodies] == [3, 6]
    assert bodies[0]["BRA"] == 1                   # the predicate is dropped


def test_compression_loop_is_the_rotate_heaviest_loop_of_the_kernel():
    body = sass.compression_loop(LISTING)
    assert body == {"LDS.128": 1, "SHF.R.W.U32": 2, "LOP3.LUT": 1,
                    "IMAD": 1, "BRA": 1}           # not the other kernel's
    got = sass.per_round(body, rounds=2)
    assert got["instructions_per_round"] == 3.0
    assert got["per_round"]["SHF.R.W.U32"] == 1.0
    assert sass.compression_loop(LISTING, kernel="no_such_kernel") is None
