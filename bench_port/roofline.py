"""The benchmark's own count of a stage's work, and the card's peaks.

A stage's work is the algorithm's, counted from the cell's shapes and not
from the kernels that happen to compute it, so a fused or replaced kernel
leaves the yardstick as it is:

the match: quantize (K1 ColorGradient at both levels, K2 DepthNormal
once), spread + response (K3, both modalities at both levels), the
level-1 coarse sweep over the bank (K6) and the 16x16 level-0 sweeps of
the live candidates (K4).

Bytes are each input read once and each output written once; operations
are the per-pixel counts of each algorithm (copied from the repo's
``chip_smoke.py``: K1 136 int + 23 float, K2 123 int + 29 float, K3 40
int a pixel; K6 one add a feature a grid cell; K4 256 adds a
live feature). K4's bytes count its tables and outputs and leave out the
response planes its tiles read, which depend on where the candidates
lie; its operations count the live slots at the bank's mean level-0
features a template.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at 700 W: HBM 3.35 TB/s; 67 TFLOP/s
# float32 counts a fused multiply-add as 2, so 33.5 T single operations a
# second run on the CUDA cores (132 SMs x 128 lanes x 1.98 GHz), of which
# int32 has half the lanes: 16.7 T int32 operations a second.
HBM_BYTES_S = 3.35e12
ALL_OPS_S = 33.5e12
INT32_OPS_S = 16.7e12
POWER_W = 700.0

K1_INT, K1_FP = 136, 23
K2_INT, K2_FP = 123, 29
K3_INT = 40


def bound_ms(nbytes: float, int_ops: float = 0.0, fp_ops: float = 0.0) -> float:
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(int_ops / INT32_OPS_S, (int_ops + fp_ops) / ALL_OPS_S)
    return max(t_bytes, t_ops) * 1e3


def match_work(s: dict):
    """(bytes, int ops, float ops) of one batch's match stage at shapes ``s``
    (an entry's ``shapes()``)."""
    B, H, W = s["B"], s["H"], s["W"]
    t0, t1 = s["t_at_level"]
    mods = s["modalities"]
    H1, W1 = H // 2, W // 2
    px0, px1 = B * H * W, B * H1 * W1
    nbytes = int_ops = fp_ops = 0.0
    if "ColorGradient" in mods:  # K1 at both levels: BGR in, orientations out
        nbytes += 4 * (px0 + px1)
        int_ops += K1_INT * (px0 + px1)
        fp_ops += K1_FP * (px0 + px1)
    if "DepthNormal" in mods:  # K2 once at level 0: int32 depth in, u8 out
        nbytes += 5 * px0
        int_ops += K2_INT * px0
        fp_ops += K2_FP * px0
    # K3 per modality and level: u8 in, 8 u8 responses out
    nbytes += 9 * len(mods) * (px0 + px1)
    int_ops += K3_INT * len(mods) * (px0 + px1)
    # K6: the T1-decimated planes (one byte a response cell), the tables
    # (plane, dr, dc int32 a feature, a count a template) and the int32
    # score grid out; one add a feature a grid cell
    gh, gw = H1 // t1, W1 // t1
    nT = len(s["nfeat_l1"])
    f1 = sum(s["nfeat_l1"])
    nbytes += 8 * len(mods) * B * H1 * W1 + 12 * f1 + 4 * nT + 4 * B * nT * gh * gw
    int_ops += f1 * B * gh * gw
    # K4: the live candidates' tables in, [16, 16] int32 sums out a slot
    live_feats = B * s["live_slots"] * sum(s["nfeat_l0"]) / nT
    nbytes += 12 * live_feats + 4 * 256 * B * s["K_cap"] * len(mods)
    int_ops += 256 * live_feats
    return nbytes, int_ops, fp_ops
