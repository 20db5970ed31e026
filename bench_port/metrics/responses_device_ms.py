"""responses_device_ms: device ms a batch of the operations launched under
the program's ``match.responses`` span: the four K3 launches (spread and
responses at both levels) (bench_port/program_trace.py's device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.responses")
