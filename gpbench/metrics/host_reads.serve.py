"""Reads of device values on the host a request inside the program
(``cggp_tpu_torch.tracing.host_read``), in the traced stretch."""

from gpbench import program_trace


def read(ctx):
    return program_trace.host_reads(ctx, "requests")
