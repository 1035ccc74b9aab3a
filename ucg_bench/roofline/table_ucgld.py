"""One step's pair work of ``pair_style table_ucgld``: what the forces on
x and on lambda need, the outputs every step has, per unordered pair within
the table cutoff (Newton's third law: geometry and lookups once, tallies at
both ends).  Pair energy, virial and scores are left out: only a thermo row
or a state fix reads them.  A fused multiply-add counts two.

    minimum-image difference and r^2       3 + 5       8
    bin and fraction in r^2                            3
    4 state tables x (e, f/r), linear      4 x 2 x 2  16
    state weight products w_i[s] w_j[t]                4
    mixed f/r over the 4 combinations      4 FMA       8
    force vector, +f on i and -f on j      3 + 3 + 3   9
    lambda force on i and on j             2 x (2 + 4 + 1)  14
                                                      --
                                                      62
"""

OPS_PER_PAIR = 62
# x (3 floats), lambda, type in; f (3 floats), lambda force out; 4 bytes each
BYTES_PER_BEAD = (3 + 1 + 1) * 4 + (3 + 1) * 4
TABLE_CHANNELS = 2          # e and f/r
