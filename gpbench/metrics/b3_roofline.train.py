"""B3 (csrc/pallas_gram.cu, kuu_matvec) in training: the Gram products' bound over its device time (%)."""

from gpbench import readers


def read(ctx):
    return readers.b3_roofline(ctx)
