"""host_syncs: deliberate device-to-host reads a batch, the increments of
the program's ``sync.*`` counters (``profiling.counts``) over the host
pass of bench_port/program_trace.py (spans on, no profiler)."""

from bench_port import program_trace


def read(run):
    return program_trace.host_value(run, "syncs")
