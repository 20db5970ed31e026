"""The benchmark of object_detector_6d_tpu_torch (see run.py)."""
