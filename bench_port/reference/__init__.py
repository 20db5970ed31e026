"""The plain reference that decides ``correct``: LINEMOD's match written
from the algorithm (Hinterstoisser et al., TPAMI 2012, and OpenCV's
``linemod.cpp``), in plain PyTorch on any device, one frame at a time.

``quantize.py`` quantizes a frame (colour gradients, depth normals, the
level-1 image); ``match.py`` spreads, computes the response maps, sweeps
the bank over level 1, takes the top-K and refines each candidate at
level 0, returning the [5, K+1] record the match program returns. It
takes the frames and the template bank as the benchmark makes them
(``bench_port/bank.py``) and imports nothing of the program.

``precision="bfloat16"`` is the control: every float step rounded to
bfloat16 instead of float32.
"""
