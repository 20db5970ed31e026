"""coarse_device_ms: device ms a batch of the operations launched under the
program's ``match.coarse`` span: the level-1 decimation and its ``cat``,
K6, the span mask, the raw threshold, the count through it and the flat
score (bench_port/program_trace.py's device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.coarse")
