"""Device milliseconds a training step in the matrix-free solve's matvec
VJP (the ``cggp.cg.vjp`` spans' CUDA events)."""

from gpbench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "cggp.cg.vjp", "steps")
