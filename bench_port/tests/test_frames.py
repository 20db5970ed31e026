"""The benchmark's torch frame generator against the repo's numpy one
(chip_smoke.py ``make_frames`` over tools/scenes.py) on the CPU.

Depth (mm) and the object masks are equal. The gray texture may differ
only where two source pixels of one object splat to the same target pixel
at the same depth (the numpy original keeps whichever its unstable
argsort put last, the copy the highest source index): at most
``MAX_GRAY_DIFF`` pixels a frame, each on such a pixel.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from bench_port import frames

ROOT = pathlib.Path(__file__).resolve().parents[2]
PLACEMENTS = [
    {"class_id": "objA", "center": [0.0, 0.0, 0.0], "half": [0.05, 0.04, 0.04]},
    {"class_id": "objB", "center": [-0.26, 0.11, 0.04], "half": [0.03, 0.03, 0.03]},
]
OBJECTS = {"objA": 1.0, "objB": 0.78}
MAX_GRAY_DIFF = 40


@pytest.fixture(scope="module")
def scenes():
    sys.path.insert(0, str(ROOT / "tools"))
    import scenes as s

    return s


def test_snowman_scene(scenes):
    for scale in (1.0, 0.78):
        d, g, m = scenes.snowman_scene(scale=scale)
        d2, g2, m2 = (x.numpy() for x in frames.snowman_scene(scale))
        assert np.array_equal(d.astype(np.int32), d2)
        assert np.array_equal(g, g2) and np.array_equal(m, m2)


@pytest.mark.parametrize("seed", [0, 200, 2**31 + 7])
def test_make_frames(scenes, seed):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    n = 6
    depths, rgbs, gts = chip_smoke.make_frames(scenes, scenes.K_DEFAULT, n, seed % 2**32)
    maker = frames.FrameMaker(OBJECTS, PLACEMENTS)
    t = frames.draw_translations(np.random.RandomState(seed % 2**32), PLACEMENTS, n)
    for f in range(n):
        assert np.array_equal(t[f, 0], gts[f]["objA"]) and np.array_equal(t[f, 1], gts[f]["objB"])
    d, c = maker.render(t)
    assert np.array_equal(d.numpy(), depths.astype(np.int32))
    diff = (c.numpy() != rgbs).any(-1)
    assert diff.reshape(n, -1).sum(1).max() <= MAX_GRAY_DIFF
    assert (c[..., 0] == c[..., 1]).all() and (c[..., 0] == c[..., 2]).all()


def test_pool_from_any_seed():
    maker = frames.FrameMaker(OBJECTS, PLACEMENTS)
    a = frames.make_pool(maker, 3, 2**31 + 12345)
    b = frames.make_pool(maker, 3, 2**31 + 12345)
    c = frames.make_pool(maker, 3, 2**31 + 12346)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.uint8
    assert tuple(a[1].shape) == (3, 480, 640, 3)
