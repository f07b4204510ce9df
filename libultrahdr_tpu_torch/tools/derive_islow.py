"""Derive the libjpeg 'islow' IDCT as an exact integer matrix: the port's
counterpart of the JAX repository's ``tools/derive_islow.py``.

    python -m libultrahdr_tpu_torch.tools.derive_islow

The jpeg_idct_islow kernel (libjpeg jidctint.c; the Loeffler-Ligtenberg-
Moshovitz scaled-integer butterfly, CONST_BITS=13, PASS1_BITS=2) runs two
passes of the same 1-D butterfly, each exactly linear in its inputs (adds
and multiplies only, one DESCALE rounding at the end of the pass).  So each
pass is

    out = (M @ x + 2^(s-1)) >> s        over int32 (wrapping) arithmetic,

with s=11 for the column pass and s=18 (then +128 and range_limit) for the
row pass, and M one integer matrix for both.  This derives M by pushing
unit vectors through the butterfly written from the published constants,
prints it as the ``kIslowM`` table that the port's host engine embeds
(``csrc/host/host_decode.cpp``), and checks it against the exact real
IDCT.  Pure Python: no numpy, no torch.
"""

import math

F_0_298631336 = 2446
F_0_390180644 = 3196
F_0_541196100 = 4433
F_0_765366865 = 6270
F_0_899976223 = 7373
F_1_175875602 = 9633
F_1_501321110 = 12299
F_1_847759065 = 15137
F_1_961570560 = 16069
F_2_053119869 = 16819
F_2_562915447 = 20995
F_3_072711026 = 25172

CONST_BITS = 13


def islow_1d_linear(x):
    """One 1-D islow butterfly WITHOUT the final descale: the 8
    pre-descale sums (exact ints, linear in x)."""
    # even part
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * F_0_541196100
    t2 = z1 - z3 * F_1_847759065
    t3 = z1 + z2 * F_0_765366865
    t0 = (x[0] + x[4]) << CONST_BITS
    t1 = (x[0] - x[4]) << CONST_BITS
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    # odd part
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * F_1_175875602
    o0 *= F_0_298631336
    o1 *= F_2_053119869
    o2 *= F_3_072711026
    o3 *= F_1_501321110
    z1 *= -F_0_899976223
    z2 *= -F_2_562915447
    z3 = z3 * -F_1_961570560 + z5
    z4 = z4 * -F_0_390180644 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def derive_matrix():
    """M[out][k]: the butterfly's response at output `out` to a unit
    input at `k`."""
    cols = [islow_1d_linear([1 if i == k else 0 for i in range(8)])
            for k in range(8)]
    return [[cols[k][o] for k in range(8)] for o in range(8)]


def max_basis_error(m) -> float:
    """max |M / 2^13 - 2 sqrt(2) B| over the orthonormal 1-D IDCT basis B
    (the per-pass scale 2 sqrt(2): two passes and the final >> 3 make the
    /8 of the 2-D IDCT); the fixed-point rounding of the constants."""
    err = 0.0
    for n in range(8):
        for k in range(8):
            ck = math.sqrt(0.125) if k == 0 else 0.5
            b = ck * math.cos((2 * n + 1) * k * math.pi / 16.0)
            err = max(err, abs(m[n][k] / (1 << CONST_BITS)
                               - 2.0 * math.sqrt(2.0) * b))
    return err


def main():
    m = derive_matrix()
    print("static const int32_t kIslowM[8][8] = {")
    for row in m:
        print("    {" + ", ".join(f"{v}" for v in row) + "},")
    print("};")
    print(f"// max |M/8192 - 2sqrt2*B| = {max_basis_error(m):.3e} "
          "(fixed-point rounding)")


if __name__ == "__main__":
    main()
