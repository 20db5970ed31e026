"""refine_device_ms: device ms a batch of the operations launched under the
program's ``match.refine`` span: ``bank_max_dr``, the anchors, and per
modality ``build_D``, the table gathers and K4 with its bounds check
(bench_port/program_trace.py's device pass)."""

from bench_port import program_trace


def read(run):
    return program_trace.stage_ms(run, "match.refine")
