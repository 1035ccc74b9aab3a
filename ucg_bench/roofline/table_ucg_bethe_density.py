"""One step's pair work of ``pair_style table_ucg_bethe_density``: what the
force on x needs, per unordered pair within the table cutoff, over the
style's three passes (local density, Bethe mixing with the prior forces,
the CV back-force).  Scores, the posterior and the pair energy are left out:
only observables read them.  A transcendental function (tanh, exp, expm1,
log, sqrt) counts one; a fused multiply-add two.

    pass 1  minimum image and r^2, r               8 + 1        9
            proximity w(r) at both ends            2 x 5       10
            density tallies                                     2
    pass 2  bin and fraction                                    3
            4 state tables x (e, f/r), linear      4 x 2 x 2   16
            J, -J/kT, exp, expm1                   3 + 1 + 2    6
            Bethe root: Q, D, sqrt, root           3 + 6 + 1 + 5  15
            p00, p01, p10                                       4
            mixed f/r over the 4 combinations      4 FMA        8
            force vector, +f on i and -f on j                   9
            stable log ratio at both ends          2 x 16      32
            prior-force tallies at both ends       2 x 4        8
    pass 3  -dw/dr at both ends                    2 x 3        6
            (cvf_i g_i + cvf_j g_j) / r                         4
            force vector, +f on i and -f on j                   9
                                                               --
                                                              141
"""

OPS_PER_PAIR = 141
# x (3 floats) and type in, f (3 floats) out; 4 bytes each
BYTES_PER_BEAD = (3 + 1) * 4 + 3 * 4
TABLE_CHANNELS = 2          # e and f/r
