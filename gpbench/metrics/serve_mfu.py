"""Serving requests' model FLOPs over the traced stretch's time and the fp32-accurate peak (%)."""

from gpbench import readers


def read(ctx):
    return readers.mfu(ctx, "requests")
