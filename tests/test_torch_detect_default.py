"""The depth-only slice as a whole at the default DetectParams schedule
(test_torch_detect.py holds the promoted schedule and the shared setup)."""

import torch

from test_torch_detect import check_schedule

torch.set_num_threads(1)


def test_detect_fused_batch_equals_reference_default():
    check_schedule("default")
