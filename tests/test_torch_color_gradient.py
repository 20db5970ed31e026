"""Port parity: colour-gradient quantize (kernel K1's plain twin),
``pyr_down_u8`` and the colour-gradient pyramid's template extraction,
against the JAX package.

The twin must be bit-exact with the reference's XLA formulation (``q``
and the magnitude), with its Pallas kernel in interpret mode and with
the oracle goldens; ``pyr_down_u8`` must be bit-exact with the
reference's and with cv::pyrDown's golden; the pyramid must extract the
reference's features at both levels.
"""

import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.ops.quantize_pallas import cg_quantize_batched as ref_cg_pallas
from object_detector_6d_tpu.quant.color_gradient import quantized_orientations as ref_qo
from object_detector_6d_tpu.quant.pyramid import ColorGradientPyramid as RefCGPyramid
from object_detector_6d_tpu.quant.pyramid import pyr_down_u8 as ref_pyr_down
from object_detector_6d_tpu_torch.ops import kernels
from object_detector_6d_tpu_torch.ops.quantize import cg_quantize_batched
from object_detector_6d_tpu_torch.quant import color_gradient
from object_detector_6d_tpu_torch.quant.color_gradient import quantized_orientations
from object_detector_6d_tpu_torch.quant.pyramid import ColorGradientPyramid, pyr_down_u8

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)


def _colour_frames(seed, B, H, W):
    """Checkerboard + ramp + noise with channels that differ (so the
    channel select is exercised, not only its tie rule), plus a region of
    flat gray (every channel tied)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = ((xx // 8 + yy // 8) % 2) * 160
    ramp = xx * 255 // W
    out = []
    for _ in range(B):
        img = np.stack([base + rng.randint(0, 40, (H, W)), ramp + rng.randint(0, 40, (H, W)),
                        rng.randint(0, 256, (H, W))], -1)
        img[: H // 4] = img[: H // 4, :, :1]  # gray rows: three equal channels
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.uint8)


@pytest.mark.parametrize("H,W", [(64, 96), (47, 61)])
def test_cg_twin_equals_reference_q_and_mag(H, W):
    bgrs = _colour_frames(0, 2, H, W)
    q, mag = quantized_orientations(torch.as_tensor(bgrs), 10.0)
    assert q.dtype == torch.uint8 and mag.dtype == torch.float32
    rq, rmag = jax.vmap(lambda im: ref_qo(im, 10.0))(jnp.asarray(bgrs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(mag.numpy(), np.asarray(rmag))
    assert q.numpy().any()


@pytest.mark.parametrize("weak", [10.0, 30.0])
def test_cg_twin_equals_pallas_kernel(weak):
    bgrs = _colour_frames(1, 2, 48, 160)
    want = np.asarray(ref_cg_pallas(jnp.asarray(bgrs), weak, interpret=True))
    got = cg_quantize_batched(torch.as_tensor(bgrs), weak)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["sphere", "noise"])
def test_cg_twin_equals_oracle_golden(golden, case):
    g = golden("cg_quantize")
    got = cg_quantize_batched(torch.as_tensor(g[f"{case}_in"])[None])[0]
    np.testing.assert_array_equal(got.numpy(), g[f"{case}_q"])


def test_cg_flat_image_is_all_zero():
    assert not cg_quantize_batched(torch.full((1, 48, 140, 3), 77, dtype=torch.uint8)).any()


def test_kernel_constants_equal_the_twins():
    """csrc/cg_quantize.cu spells the fastAtan2 coefficients, epsilon and
    bin scale as hex float literals: they must be the twin's float32s."""
    src = (kernels.CSRC / "cg_quantize.cu").read_text()
    lit = dict(re.findall(r"constexpr float (\w+) = (-?0x[0-9a-fp.+-]+)f;", src))
    want = dict(zip(("P1", "P3", "P5", "P7"), color_gradient.ATAN_P),
                EPS=color_gradient.ATAN_EPS, BIN_SCALE=color_gradient.BIN_SCALE)
    assert {k: float.fromhex(v) for k, v in lit.items()} == want


@pytest.mark.parametrize("shape", [(64, 96, 3), (47, 61, 3), (47, 61), (2, 33, 50, 3)])
def test_pyr_down_equals_reference(shape):
    img = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    got = pyr_down_u8(torch.as_tensor(img)).numpy()
    ref = ref_pyr_down if len(shape) < 4 else jax.vmap(ref_pyr_down)
    np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(img))))


def test_pyramid_equals_pyr_probe_golden(golden):
    """cv::pyrDown's output and the oracle's quantized levels 0 and 1."""
    g = golden("pyr_probe")
    np.testing.assert_array_equal(pyr_down_u8(torch.as_tensor(g["cg_in"])).numpy(),
                                  g["cg_down_oracle"])
    pyr = ColorGradientPyramid(g["cg_in"], levels=2, device="cpu")
    np.testing.assert_array_equal(pyr.quantize(0), g["cg_q0"])
    np.testing.assert_array_equal(pyr.quantize(1), g["cg_q1"])


def test_pyramid_extraction_equals_reference():
    """Template features of the snowman's gray view at both levels."""
    _, gray, mask = scenes.snowman_scene()
    bgr = np.repeat(gray[..., None], 3, axis=2)
    m = mask.astype(np.uint8) * 255
    ours = ColorGradientPyramid(bgr, levels=2, mask=m, device="cpu")
    ref = RefCGPyramid(bgr, levels=2, mask=m)
    for lvl in range(2):
        a, b = ours.extract_template(lvl), ref.extract_template(lvl)
        assert a is not None and b is not None
        assert (a.width, a.height, a.pyramid_level) == (b.width, b.height, b.pyramid_level)
        np.testing.assert_array_equal(a.feature_array(), b.feature_array())
