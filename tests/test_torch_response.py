"""Port parity: fused spread + response maps (kernel K3's plain twin)
against the reference's Pallas kernel in interpret mode. Integer only:
bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.match.response import response_maps as ref_rm
from object_detector_6d_tpu.match.response import spread as ref_spread
from object_detector_6d_tpu.ops.response_pallas import response_spread_batched as ref_pallas
from object_detector_6d_tpu_torch.ops.response import response_spread_batched

torch.set_num_threads(1)


def _onehot(rng, B, H, W, density=0.3):
    """Random one-hot orientation bytes with empty (0) pixels."""
    q = (1 << rng.randint(0, 8, (B, H, W))).astype(np.uint8)
    return np.where(rng.uniform(size=(B, H, W)) < density, q, 0).astype(np.uint8)


@pytest.mark.parametrize("t", [5, 8])
def test_response_twin_equals_pallas_kernel(t):
    rng = np.random.RandomState(t)
    q = _onehot(rng, 2, 32, 128)
    want = np.asarray(ref_pallas(jnp.asarray(q), t, interpret=True))
    got = response_spread_batched(torch.as_tensor(q), t)
    assert got.shape == (2, 8, 32, 128) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t,H,W", [(5, 47, 61), (8, 29, 130), (3, 16, 16)]
                         + [(t, 13, 21) for t in range(1, 17)])
def test_response_twin_equals_xla_any_size(t, H, W):
    rng = np.random.RandomState(H)
    q = _onehot(rng, 1, H, W, density=0.6)
    want = np.asarray(ref_rm(ref_spread(jnp.asarray(q[0]), t)))
    got = response_spread_batched(torch.as_tensor(q), t)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_response_every_byte_value_equals_reference():
    """At T=1 the spread is the identity: a frame of all 256 byte values
    covers every entry of the kernel's response table."""
    q = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(ref_rm(jnp.asarray(q)))
    got = response_spread_batched(torch.as_tensor(q[None]), 1)[0]
    np.testing.assert_array_equal(got.numpy(), want)
