"""The reference, written from LINEMOD's algorithm, gives the port's plain
path's bits stage by stage on the CPU: pyrDown, the two quantizers (on
rendered frames and on noise), the normal table against the port's octant
rule on every cell, and the spread response maps."""

import numpy as np
import pytest
import torch

from bench_port import frames
from bench_port.reference import match, quantize

F32 = quantize.rounding("float32")


@pytest.fixture(scope="module")
def pool():
    maker = frames.FrameMaker({"objA": 1.0, "objB": 0.78}, [
        {"class_id": "objA", "center": [0.0, 0.0, 0.0], "half": [0.05, 0.04, 0.04]},
        {"class_id": "objB", "center": [-0.26, 0.11, 0.04], "half": [0.03, 0.03, 0.03]}])
    depth, bgr = frames.make_pool(maker, 2, 31)[:2]
    g = torch.Generator().manual_seed(0)
    noise_bgr = torch.randint(0, 256, (1, 96, 128, 3), dtype=torch.uint8, generator=g)
    noise_depth = torch.randint(600, 760, (1, 96, 128), dtype=torch.int32, generator=g)
    noise_depth[:, :, 64:] += 300  # a step the ring samples cut
    return depth, bgr, noise_depth, noise_bgr


def test_pyr_down(pool):
    from object_detector_6d_tpu_torch.quant.pyramid import pyr_down_u8

    for img in (pool[1], pool[3], pool[3][:, :95, :127]):
        assert torch.equal(quantize.pyr_down(img), pyr_down_u8(img))


def test_color_gradient(pool):
    from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_plain

    for img in (pool[1], pool[3], quantize.pyr_down(pool[1])):
        want = cg_quantize_plain(img, 10.0)
        assert int((want > 0).sum()) > 100
        assert torch.equal(quantize.color_gradient(img, 10.0, F32), want)


def test_depth_normal(pool):
    from object_detector_6d_tpu_torch.ops.quantize import dn_quantize_plain

    for d in (pool[0], pool[2]):
        want = dn_quantize_plain(d, 2000, 50)
        assert int((want > 0).sum()) > 100
        assert torch.equal(quantize.depth_normal(d, 2000, 50, F32), want)


def test_normal_table_is_the_octant_rule():
    """Equal on every cell a unit normal can reach: the 20 x 20 table, and
    of the index 20 (nx or ny rounded to 1) the cells next to the axis;
    the reference clamps 20 to 19 there."""
    from object_detector_6d_tpu_torch.quant.depth_normal import octant_bins

    v = torch.arange(21)
    vy, vx = torch.meshgrid(v, v, indexing="ij")
    want = 1 << octant_bins(vx, vy)
    table = torch.as_tensor(quantize.NORMAL_TABLE).to(torch.int64)
    got = table[vy.clamp(max=19), vx.clamp(max=19)]

    def gap(c):  # from 10 to the nearest point of the cell [c, c + 1)
        return (torch.clamp(torch.tensor(10.0), c.float(), c.float() + 1) - 10).abs()

    reachable = gap(vx) ** 2 + gap(vy) ** 2 <= 100.0
    assert int(reachable[20].sum()) == 2 and int(reachable[:20, :20].sum()) > 300
    assert torch.equal(got[reachable], want[reachable])


@pytest.mark.parametrize("t", [1, 5, 8])
def test_responses(pool, t):
    from object_detector_6d_tpu_torch.ops.response import response_spread_plain

    q = quantize.color_gradient(pool[3], 10.0, F32)
    assert torch.equal(match.responses(match.spread(q, t)), response_spread_plain(q, t))
