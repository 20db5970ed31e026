"""End-to-end ADD parity of the port on tools/parity_add.py's base and
occl sets (64 scenes each, imported as they are), on the CPU, through
parity_torch.py's own runner: the port trained with its ``add_view`` and
each scene through ``PoseDetector.detect_fused``, the JAX package's
``detect_fused`` on the same scenes.

For each set: the port's ADD-0.1d is no lower than the OpenCV oracle
golden's, and the scenes it gets within 0.1 d are exactly the
reference's. This file runs base at the default schedule;
test_torch_parity_occl.py, test_torch_parity_promoted.py and
test_torch_parity_promoted_occl.py the other three (one set and
schedule a file, ~2 min each, so that test workers take them side by
side).
"""

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
import parity_torch  # noqa: E402

torch.set_num_threads(1)


def check_parity(config, schedule):
    port = parity_torch.run_set(parity_torch.port_detector(schedule, "cpu"), config)
    ref = parity_torch.run_set(parity_torch.reference_detector(schedule), config)
    rec = parity_torch.summarize(config, schedule, port, ref)
    assert rec["instances"] == 64
    assert rec["fallback"] == rec["reference"]["fallback"]
    assert rec["port"]["add_01d"] >= rec["oracle"]["add_01d"], rec
    assert rec["reference"]["success_differs"] == [], rec["reference"]
    assert rec["reference"]["found_differs"] == [], rec["reference"]


def test_parity_base_default_schedule():
    check_parity("base", "default")
