"""Host time until a request's call returns, before its results are read, per request (ms)."""

from gpbench import readers


def read(ctx):
    return readers.enqueue_ms(ctx, "requests")
