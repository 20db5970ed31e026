"""quantize_device_ms: device ms a batch of the operations launched under the
program's ``match.quantize`` span: K1 at both levels, ``pyr_down_u8``, K2
and the level-1 ``[::2, ::2]`` subsample (bench_port/program_trace.py's
device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.quantize")
