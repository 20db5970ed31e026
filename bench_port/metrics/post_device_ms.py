"""post_device_ms: device ms a batch of the operations launched under the
program's ``match.post`` span: ``post_stage`` and the record's trim to 5
rows (bench_port/program_trace.py's device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.post")
