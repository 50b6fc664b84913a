"""CG steps a training step, forward and backward solves together."""

from gpbench import readers


def read(ctx):
    return readers.cg_steps_per(ctx, "steps")
