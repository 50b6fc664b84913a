"""CG steps per serving solve (one solve a serving batch)."""

from gpbench import readers


def read(ctx):
    return readers.cg_steps_per(ctx, "solves")
