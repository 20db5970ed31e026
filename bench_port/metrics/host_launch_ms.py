"""host_launch_ms: host ms a batch inside the program's ``match.*`` spans less
``host_sync_wait_ms``: the host's time to launch the match program's
operations, over the host pass of bench_port/program_trace.py (spans on,
no profiler)."""

from bench_port import program_trace


def read(run):
    return program_trace.host_value(run, "launch_ms")
