"""host_sync_wait_ms: host ms a batch inside the program's ``sync.*`` spans
(K4's bounds check waiting for the card), over the host pass of
bench_port/program_trace.py (spans on, no profiler)."""

from bench_port import program_trace


def read(run):
    return program_trace.host_value(run, "sync_wait_ms")
