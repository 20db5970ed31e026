"""topk_device_ms: device ms a batch of the operations launched under the
program's ``match.topk`` span: K7 ``select_topk`` (three launches over the
whole batch's grid) and the template ids and anchors taken from its
indices (bench_port/program_trace.py's device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.topk")
