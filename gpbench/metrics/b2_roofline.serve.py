"""B2 (csrc/pallas_cg.cu) in serving: its algorithm-level bound over its device time (%)."""

from gpbench import readers


def read(ctx):
    return readers.b2_roofline(ctx)
