"""The benchmark's count of the match stage's work against chip_smoke.py's
per-kernel bytes and operations at PERF.md's shapes (the two-modality
B=32 batch, 122 templates: K1 49.2 MB and 1.95 G operations, K2 49.2 MB
and 1.50 G, K3 221.2 MB and 0.98 G, K6 58.2 MB and 0.29 G). K6's tables are counted at their features, not at
chip_smoke's padded width, so its bytes agree within 0.5%."""

import pathlib
import sys

import pytest

from bench_port import roofline

ROOT = pathlib.Path(__file__).resolve().parents[2]
B, H, W = 32, 480, 640
MODS = ("ColorGradient", "DepthNormal")


def shapes(**over):
    s = dict(B=B, H=H, W=W, t_at_level=(5, 8), modalities=MODS, nfeat_l1=[62] * 122,
             nfeat_l0=[126] * 122, K_cap=16, live_slots=0.0)
    s.update(over)
    return s


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_constants_are_chip_smokes(smoke):
    for name in ("HBM_BYTES_S", "ALL_OPS_S", "INT32_OPS_S", "K1_INT", "K1_FP", "K2_INT",
                 "K2_FP", "K3_INT"):
        assert getattr(roofline, name) == getattr(smoke, name)
    for args in ((1e6,), (1e6, 1e9), (1e6, 1e9, 3e9), (1e12, 0.0, 0.0)):
        assert roofline.bound_ms(*args) == smoke.bound_ms(*args)[0]


def test_match_work_is_the_sum_of_the_kernels():
    px0, px1 = B * H * W, B * (H // 2) * (W // 2)
    k1 = (4 * (px0 + px1), 136 * (px0 + px1), 23 * (px0 + px1))
    k2 = (5 * px0, 123 * px0, 29 * px0)
    k3 = (9 * 2 * (px0 + px1), 40 * 2 * (px0 + px1), 0)
    assert k1[0] == pytest.approx(49.2e6, rel=2e-3) and k1[1] + k1[2] == pytest.approx(1.95e9, rel=3e-3)
    assert k2[0] == pytest.approx(49.2e6, rel=2e-3) and k2[1] + k2[2] == pytest.approx(1.50e9, rel=5e-3)
    assert k3[0] == pytest.approx(221.2e6, rel=2e-3) and k3[1] == pytest.approx(0.98e9, rel=5e-3)
    nbytes, int_ops, fp_ops = roofline.match_work(shapes())
    k6_bytes = nbytes - k1[0] - k2[0] - k3[0] - 4 * 256 * B * 16 * 2
    k6_ops = int_ops - k1[1] - k2[1] - k3[1]
    assert k6_bytes == pytest.approx(58.2e6, rel=5e-3)
    assert k6_ops == pytest.approx(0.29e9, rel=5e-3) and k6_ops == 122 * 62 * B * 30 * 40
    assert fp_ops == k1[2] + k2[2]


def test_live_slots_add_k4():
    a = roofline.match_work(shapes())
    b = roofline.match_work(shapes(live_slots=10.0))
    assert b[1] - a[1] == 256 * B * 10.0 * 126
    assert b[0] - a[0] == 12 * B * 10.0 * 126
