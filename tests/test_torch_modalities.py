"""Port parity: the modality front ends (ColorGradient, DepthNormal) and
the one-frame kernel wrappers (response_spread, refine_sweep) against the
JAX package, bitwise.

The front ends quantize one frame through K1 / K2's wrappers at B=1 (their
plain twins on the CPU) and must equal the reference's classes and the
OpenCV oracle goldens that tests/test_color_gradient.py and
tests/test_depth_normal.py hold the reference to. The one-frame wrappers
must equal the reference's Pallas wrappers in interpret mode, at shapes
Mosaic takes for K4 (power-of-two planes, Wp >= 128, Hp >= 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.ops.refine_pallas import refine_sweep as ref_refine_sweep
from object_detector_6d_tpu.ops.response_pallas import response_spread as ref_response_spread
from object_detector_6d_tpu.quant.color_gradient import ColorGradient as RefColorGradient
from object_detector_6d_tpu.quant.depth_normal import DepthNormal as RefDepthNormal
from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.ops.refine import refine_sweep, refine_sweep_batched
from object_detector_6d_tpu_torch.ops.response import response_spread, response_spread_batched
from object_detector_6d_tpu_torch.quant.color_gradient import ColorGradient
from object_detector_6d_tpu_torch.quant.depth_normal import DepthNormal

torch.set_num_threads(1)

DN_CASES = ["rand", "rand2", "sphere640", "holes", "far", "ramp0", "ramp37", "ramp101",
            "ramp215", "ramp303"]


def test_front_ends_mirror_the_reference():
    assert ColorGradient.name == RefColorGradient.name == "ColorGradient"
    assert DepthNormal.name == RefDepthNormal.name == "DepthNormal"
    assert ColorGradient(device="cpu").params == ColorGradientParams()
    p = DepthNormalParams(distance_threshold=1500, difference_threshold=30)
    assert DepthNormal(p, device="cpu").params is p


@pytest.mark.parametrize("case", ["noise", "sphere"])
def test_color_gradient_quantize_equals_golden_and_reference(golden, case):
    g = golden("cg_quantize")
    img = g[case + "_in"]
    got = ColorGradient(device="cpu").quantize(img)
    assert got.dtype == torch.uint8 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got.numpy(), g[case + "_q"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(RefColorGradient().quantize(img)))
    # a tensor is quantized on its own device
    same = ColorGradient(device="cuda").quantize(torch.as_tensor(img))
    assert torch.equal(same, got)


@pytest.mark.parametrize("weak", [10.0, 35.0])
def test_color_gradient_params_reach_the_kernel(golden, weak):
    img = golden("cg_quantize")["noise_in"]
    got = ColorGradient(ColorGradientParams(weak_threshold=weak), device="cpu").quantize(img)
    from object_detector_6d_tpu.core.config import ColorGradientParams as RefParams

    want = RefColorGradient(RefParams(weak_threshold=weak)).quantize(img)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", DN_CASES)
def test_depth_normal_quantize_equals_golden_and_reference(golden, case):
    g = golden("dn_quantize")
    dep = g[case + "_in"]
    got = DepthNormal(device="cpu").quantize(dep)
    assert got.dtype == torch.uint8 and got.shape == dep.shape
    np.testing.assert_array_equal(got.numpy(), g[case + "_q"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(RefDepthNormal().quantize(dep)))


def test_depth_normal_params_reach_the_kernel(golden):
    from object_detector_6d_tpu.core.config import DepthNormalParams as RefParams

    dep = golden("dn_quantize")["rand_in"]
    got = DepthNormal(DepthNormalParams(distance_threshold=1200, difference_threshold=20),
                      device="cpu").quantize(torch.as_tensor(dep.astype(np.int32)))
    want = RefDepthNormal(RefParams(distance_threshold=1200,
                                    difference_threshold=20)).quantize(dep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _onehot(rng, H, W, density=0.4):
    q = (1 << rng.randint(0, 8, (H, W))).astype(np.uint8)
    return np.where(rng.uniform(size=(H, W)) < density, q, 0).astype(np.uint8)


@pytest.mark.parametrize("t", [5, 8])
def test_response_spread_equals_reference(t):
    q = _onehot(np.random.RandomState(t), 32, 128)
    want = np.asarray(ref_response_spread(jnp.asarray(q), t, interpret=True))
    got = response_spread(torch.as_tensor(q), t)
    assert got.shape == (8, 32, 128) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  response_spread_batched(torch.as_tensor(q[None]), t)[0].numpy())


def _tables(rng, P, Hp, Wp, K, F):
    plane = rng.randint(0, P, (K, F)).astype(np.int32)
    r0 = rng.randint(0, Hp - 16 + 1, (K, F)).astype(np.int32)
    c0 = rng.randint(0, Wp - 16 + 1, (K, F)).astype(np.int32)
    return plane, r0, c0


@pytest.mark.parametrize("with_nfeat", [False, True])
def test_refine_sweep_equals_reference(with_nfeat):
    rng = np.random.RandomState(7)
    P, Hp, Wp, K, F = 4, 32, 128, 5, 9
    d = rng.randint(0, 5, (P, Hp, Wp)).astype(np.int8)
    plane, r0, c0 = _tables(rng, P, Hp, Wp, K, F)
    nfeat = np.array([0, 1, 4, 8, 9], np.int32) if with_nfeat else None
    want = np.asarray(ref_refine_sweep(
        jnp.asarray(d), jnp.asarray(plane), jnp.asarray(r0), jnp.asarray(c0),
        None if nfeat is None else jnp.asarray(nfeat), interpret=True))
    got = refine_sweep(*(torch.as_tensor(a) for a in (d, plane, r0, c0)),
                       None if nfeat is None else torch.as_tensor(nfeat))
    assert got.shape == (K, 16, 16) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # nfeat=None is every feature
    full = torch.full((1, K), F, dtype=torch.int32) if nfeat is None else \
        torch.as_tensor(nfeat)[None]
    batched = refine_sweep_batched(*(torch.as_tensor(a)[None] for a in (d, plane, r0, c0)),
                                   full)[0]
    assert torch.equal(got, batched)
