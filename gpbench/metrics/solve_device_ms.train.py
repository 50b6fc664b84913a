"""Device milliseconds a training step inside the program's CG solves,
forward and backward (the ``cggp.cg.solve`` spans' CUDA events)."""

from gpbench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "cggp.cg.solve", "steps")
