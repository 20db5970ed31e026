"""Each hand-written kernel against its plain twin, on a CUDA card.

Marked ``cuda``: every test skips without a card (decided inside the
fixture, never at import). Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``. The twins are
themselves held against the JAX package by the other test_torch_* files.
"""

import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.ops import quantize, refine, response
from object_detector_6d_tpu_torch.ops.geometry import FusedScene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _depth(rng, B, H, W):
    yy, xx = np.mgrid[0:H, 0:W]
    d = 900 + 3 * xx + 2 * yy + 40 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    d = np.broadcast_to(d, (B, H, W)) + rng.randint(0, 30, (B, H, W))
    d[:, H // 3:H // 2, W // 3:W // 2] = 0
    d[:, :, -W // 6:] = 2400
    return torch.as_tensor(d.astype(np.int32))


@pytest.mark.parametrize("H,W", [(48, 64), (53, 71)])
def test_dn_quantize_kernel_equals_twin(dev, H, W):
    d = _depth(np.random.RandomState(0), 3, H, W).to(dev)
    got = quantize.dn_quantize_batched(d)
    torch.cuda.synchronize()
    assert torch.equal(got, quantize.dn_quantize_plain(d))


@pytest.mark.parametrize("t", [1, 5, 8, 16])
def test_response_kernel_equals_twin(dev, t):
    rng = np.random.RandomState(t)
    q = (1 << rng.randint(0, 8, (2, 37, 90))) * (rng.uniform(size=(2, 37, 90)) < 0.3)
    q = torch.as_tensor(q.astype(np.uint8), device=dev)
    got = response.response_spread_batched(q, t)
    torch.cuda.synchronize()
    assert torch.equal(got, response.response_spread_plain(q, t))


def test_refine_kernel_equals_twin(dev):
    rng = np.random.RandomState(3)
    B, P, Hp, Wp, K, F = 2, 7, 41, 53, 6, 9
    D = torch.as_tensor(rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    plane = torch.as_tensor(rng.randint(0, P, (B, K, F)), dtype=torch.int32, device=dev)
    r0 = torch.as_tensor(rng.randint(0, Hp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    c0 = torch.as_tensor(rng.randint(0, Wp - 15, (B, K, F)), dtype=torch.int32, device=dev)
    nfeat = torch.as_tensor(rng.randint(0, F + 1, (B, K)), dtype=torch.int32, device=dev)
    got = refine.refine_sweep_batched(D, plane, r0, c0, nfeat)
    torch.cuda.synchronize()
    assert torch.equal(got, refine.refine_sweep_plain(D, plane, r0, c0, nfeat))


@pytest.mark.parametrize("H,W", [(48, 64), (37, 90)])
def test_fused_scene_kernel_equals_twin(dev, H, W):
    K = np.array([[70.0, 0.0, W / 2 + 0.3], [0.0, 71.0, H / 2 - 0.4], [0.0, 0.0, 1.0]])
    fs = FusedScene(H, W, K, device=dev)
    d = _depth(np.random.RandomState(1), 2, H, W).to(dev)
    got = fs(d)
    torch.cuda.synchronize()
    want = fs.plain(d)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("H,W", [(48, 64), (37, 90)])
def test_cg_quantize_kernel_equals_twin(dev, H, W):
    rng = np.random.RandomState(H)
    yy, xx = np.mgrid[0:H, 0:W]
    base = ((xx // 6 + yy // 6) % 2) * 150
    bgr = np.stack([base[None] + rng.randint(0, 60, (3, H, W)) for _ in range(3)], -1)
    bgr[:, : H // 3] = bgr[:, : H // 3, :, :1]  # gray rows: tied channels
    bgr = torch.as_tensor(np.clip(bgr, 0, 255).astype(np.uint8), device=dev)  # [3, H, W, 3]
    for weak in (10.0, 40.0):
        got = quantize.cg_quantize_batched(bgr, weak)
        torch.cuda.synchronize()
        assert torch.equal(got, quantize.cg_quantize_plain(bgr, weak))


def test_coarse_sweep_kernel_equals_twin(dev):
    rng = np.random.RandomState(5)
    B, P, Hp, Wp, nT, F = 2, 9, 13, 21, 5, 11
    D = torch.as_tensor(rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8), device=dev)
    tab = [torch.as_tensor(rng.randint(lo, hi, (nT, F)), dtype=torch.int32, device=dev)
           for lo, hi in ((-1, P + 1), (0, 6), (0, 6))]
    nfeat = torch.as_tensor([F, 3, 0, 7, 1], dtype=torch.int32, device=dev)
    for oh, ow in ((10, 17), (70, 50)):  # the second needs two output chunks
        got = refine.coarse_sweep(D, *tab, nfeat, oh, ow)
        torch.cuda.synchronize()
        assert torch.equal(got, refine.coarse_sweep_plain(D, *tab, nfeat, oh, ow))
