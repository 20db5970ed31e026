"""Lookup tables of the LINEMOD quantization/matching pipeline.

Both tables below are *data* (numerical constants of the published LINEMOD
algorithm — Hinterstoisser et al., "Gradient Response Maps for Real-Time
Detection of Texture-Less Objects"), reconstructed by
reverse-engineering the canonical compiled implementation
(libopencv_rgbd.so.4.6.0) and verified bit-exact against it via black-box
differential tests (see tests/test_depth_normal.py, tests/test_match.py).
Copied from object_detector_6d_tpu/ops/lut.py.

* ``NORMAL_LUT_2D`` — 20x20 map from a quantized surface-normal direction
  (vy, vx) = (int(ny*10+10), int(nx*10+10)) to a one-hot orientation byte
  in {1, 2, 4, ..., 128}. The compiled table is 20x20x20 indexed
  [vz][vy][vx] with *all z-slices identical*, so we store one slice.
  (vz = int(nz*20+20) is computed by the oracle but has no effect.)

* ``similarity_table()`` — 8x8 cosine-similarity scores between quantized
  orientations: score(i, j) = 4 - circular_distance_8(i, j). The oracle
  bakes this into a 256-entry max-decomposed byte LUT (SIMILARITY_LUT); we
  derive response maps directly from the 8x8 table (see match/response.py),
  which is arithmetic-identical.
"""

from __future__ import annotations

import numpy as np

NORMAL_LUT_2D = np.array(
    [
        ( 32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128),
        ( 32,  32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128, 128),
        ( 32,  32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128, 128),
        ( 32,  32,  32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128, 128, 128),
        ( 32,  32,  32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128, 128, 128),
        ( 32,  32,  32,  32,  32,  32,  32,  32,  64,  64,  64,  64,  64, 128, 128, 128, 128, 128, 128, 128),
        ( 16,  32,  32,  32,  32,  32,  32,  32,  32,  64,  64,  64, 128, 128, 128, 128, 128, 128, 128, 128),
        ( 16,  16,  16,  32,  32,  32,  32,  32,  32,  64,  64,  64, 128, 128, 128, 128, 128, 128,   1,   1),
        ( 16,  16,  16,  16,  16,  16,  32,  32,  32,  32,  64, 128, 128, 128, 128,   1,   1,   1,   1,   1),
        ( 16,  16,  16,  16,  16,  16,  16,  16,  32,  32,  64, 128, 128,   1,   1,   1,   1,   1,   1,   1),
        ( 16,  16,  16,  16,  16,  16,  16,  16,  16,  16,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1),
        ( 16,  16,  16,  16,  16,  16,  16,  16,   8,   8,   4,   2,   2,   1,   1,   1,   1,   1,   1,   1),
        ( 16,  16,  16,  16,  16,  16,   8,   8,   8,   8,   4,   2,   2,   2,   2,   1,   1,   1,   1,   1),
        ( 16,  16,  16,   8,   8,   8,   8,   8,   8,   4,   4,   4,   2,   2,   2,   2,   2,   2,   1,   1),
        ( 16,   8,   8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   2,   2,   2,   2,   2,   2,   2,   2),
        (  8,   8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   4,   4,   2,   2,   2,   2,   2,   2,   2),
        (  8,   8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   4,   4,   2,   2,   2,   2,   2,   2,   2),
        (  8,   8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   4,   4,   2,   2,   2,   2,   2,   2,   2),
        (  8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   4,   4,   4,   4,   2,   2,   2,   2,   2,   2),
        (  8,   8,   8,   8,   8,   8,   8,   4,   4,   4,   4,   4,   4,   4,   2,   2,   2,   2,   2,   2),
    ],
    dtype=np.uint8,
)


def similarity_table() -> np.ndarray:
    """8x8 orientation-similarity scores: 4 - circular distance (uint8)."""
    i = np.arange(8)[:, None]
    j = np.arange(8)[None, :]
    d = np.abs(i - j)
    d = np.minimum(d, 8 - d)
    return (4 - d).astype(np.uint8)
