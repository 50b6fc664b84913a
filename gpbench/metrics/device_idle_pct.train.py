"""Share of the traced training stretch with nothing running on the card (%)."""

from gpbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
