"""Host time until a chunk's call returns, before the synchronize, per step (ms)."""

from gpbench import readers


def read(ctx):
    return readers.enqueue_ms(ctx, "steps")
