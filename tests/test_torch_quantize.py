"""Port parity: depth-normal quantize (kernel K2's plain twin) and the
depth-normal pyramid's template extraction, against the JAX package.

The twin must be bit-exact with the reference's Pallas kernel
(``dn_quantize_batched(interpret=True)``), with its XLA formulation and
with the oracle goldens; the pyramid must reproduce the oracle's
extracted features exactly.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.ops.quantize_pallas import dn_quantize_batched as ref_dn_pallas
from object_detector_6d_tpu.quant.depth_normal import quantized_normals as ref_qn
from object_detector_6d_tpu_torch.ops.quantize import dn_quantize_batched
from object_detector_6d_tpu_torch.quant.depth_normal import quantized_normals
from object_detector_6d_tpu_torch.quant.pyramid import DepthNormalPyramid

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

torch.set_num_threads(1)


def _structured_depth(rng, H, W):
    """Sloped plane + step edges + a hole + far pixels + noise."""
    yy, xx = np.mgrid[0:H, 0:W]
    d = 900 + 3 * xx + 2 * yy
    d[(xx // 16) % 3 == 0] += 80  # steps > difference_threshold
    d[H // 3:H // 2, W // 3:W // 2] = 0  # invalid hole
    d[:, -W // 5:] = 2400  # beyond distance_threshold
    d = d + rng.randint(0, 6, (H, W))
    return d.astype(np.uint16)


@pytest.mark.parametrize("H,W,dist,diff", [(48, 160, 2000, 50), (96, 130, 2000, 50),
                                           (48, 96, 1200, 30)])
def test_dn_quantize_twin_equals_pallas_kernel(H, W, dist, diff):
    rng = np.random.RandomState(1)
    deps = np.stack([_structured_depth(rng, H, W) for _ in range(2)])
    want = np.asarray(ref_dn_pallas(jnp.asarray(deps), dist, diff, interpret=True))
    got = dn_quantize_batched(torch.as_tensor(deps.astype(np.int32)), dist, diff)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W", [(47, 61), (33, 130)])
def test_dn_quantize_twin_equals_xla_any_size(H, W):
    """Odd frame sizes the TPU kernel cannot take: the reference's XLA path."""
    rng = np.random.RandomState(4)
    dep = _structured_depth(rng, H, W)
    want = np.asarray(ref_qn(jnp.asarray(dep), 2000, 50))
    got = quantized_normals(torch.as_tensor(dep.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["rand", "rand2", "sphere640", "holes", "far",
                                  "ramp0", "ramp37", "ramp101", "ramp215", "ramp303"])
def test_dn_quantize_twin_equals_oracle_golden(golden, case):
    g = golden("dn_quantize")
    dep = torch.as_tensor(g[f"{case}_in"].astype(np.int32))[None]
    np.testing.assert_array_equal(dn_quantize_batched(dep)[0].numpy(), g[f"{case}_q"])


def test_depth_normal_pyramid_extraction_equals_oracle(golden):
    """Template features from the port's pyramid == match_dnonly A_feat*."""
    from object_detector_6d_tpu_torch.quant.features import crop_templates

    g = golden("match_dnonly")
    dep, _, mask = scenes.sphere_scene(checker_px=16)
    pyr = DepthNormalPyramid(dep, levels=2, mask=mask.astype(np.uint8) * 255, device="cpu")
    tps = [pyr.extract_template(lvl) for lvl in range(2)]
    assert all(t is not None for t in tps)
    assert tuple(crop_templates(tps)) == (246, 166, 168, 168)
    for i, t in enumerate(tps):
        np.testing.assert_array_equal(t.feature_array(), g[f"A_feat{i}"])
        assert (t.width, t.height, t.pyramid_level) == tuple(g[f"A_meta{i}"])
