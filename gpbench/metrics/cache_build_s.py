"""Seconds to build the serving cache in set-up, ending in a synchronize."""

from gpbench import readers


def read(ctx):
    return ctx.values.get("cache_build_s")
