"""Port parity: the 16x16 refinement sweep (kernel K4's plain twin) and
the match program as a whole, depth-only and with both modalities,
against the JAX package."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.core.config import ColorGradientParams as RefCGParams
from object_detector_6d_tpu.core.config import DepthNormalParams as RefDNParams
from object_detector_6d_tpu.match import program as ref_mp
from object_detector_6d_tpu.ops.refine_pallas import refine_sweep_batched as ref_sweep
from object_detector_6d_tpu.quant.features import Feature as RefFeature
from object_detector_6d_tpu.quant.features import Template as RefTemplate
from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.ops.refine import refine_sweep_batched
from object_detector_6d_tpu_torch.quant.features import Feature, Template

torch.set_num_threads(1)


def _sweep_inputs(seed, B=2, P=6, Hp=32, Wp=128, K=5, F=7):
    rng = np.random.RandomState(seed)
    D = rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8)
    plane = rng.randint(0, P, (B, K, F)).astype(np.int32)
    r0 = rng.randint(0, Hp - 16 + 1, (B, K, F)).astype(np.int32)
    c0 = rng.randint(0, Wp - 16 + 1, (B, K, F)).astype(np.int32)
    nfeat = rng.randint(0, F + 1, (B, K)).astype(np.int32)
    nfeat[0, 0] = 0  # an empty candidate
    return D, plane, r0, c0, nfeat


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_twin_equals_pallas_kernel(seed):
    args = _sweep_inputs(seed)
    want = np.asarray(ref_sweep(*(jnp.asarray(a) for a in args), interpret=True))
    got = refine_sweep_batched(*(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.int32 and got.shape == (2, 5, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_refine_any_plane_size_and_bounds_check():
    """Planes need not be powers of two; a tile leaving its plane raises."""
    D, plane, r0, c0, nfeat = _sweep_inputs(2, Hp=23, Wp=41)
    got = refine_sweep_batched(*(torch.as_tensor(a) for a in (D, plane, r0, c0, nfeat)))
    want = np.zeros_like(got.numpy())
    for b in range(D.shape[0]):
        for k in range(plane.shape[1]):
            for f in range(nfeat[b, k]):
                want[b, k] += D[b, plane[b, k, f], r0[b, k, f]:r0[b, k, f] + 16,
                                c0[b, k, f]:c0[b, k, f] + 16]
    np.testing.assert_array_equal(got.numpy(), want)
    r0[1, 2, 0] = 23 - 15
    nfeat[1, 2] = 3
    with pytest.raises(ValueError, match="leaves its plane"):
        refine_sweep_batched(*(torch.as_tensor(a) for a in (D, plane, r0, c0, nfeat)))


def _banks(g, classes, n_templates, num_mod):
    ref_ct, port_ct = {}, {}
    for cid in classes:
        r, p = [], []
        for i in range(n_templates):
            w, h, lvl = (int(v) for v in g[f"{cid}_meta{i}"])
            feats = g[f"{cid}_feat{i}"]
            r.append(RefTemplate(w, h, lvl, [RefFeature(int(x), int(y), int(q))
                                             for x, y, q in feats]))
            p.append(Template(w, h, lvl, [Feature(int(x), int(y), int(q))
                                          for x, y, q in feats]))
        ref_ct[cid], port_ct[cid] = [r], [p]
    return ref_mp.pack_bank(ref_ct, num_mod, 2), mp.pack_bank(port_ct, num_mod, 2)


K_CAP = 16


@functools.lru_cache(maxsize=2)
def _ref_program(modalities, max_dr):
    return ref_mp.make_match_program(
        modalities, (5, 8), (480, 640), RefDNParams(), RefCGParams(), K_CAP, max_dr,
        refine_impl="conv", batch=2)


def check_match_program(ref_bank, bank, modalities, ref_sources, thr):
    """[B, 5, K+1] of the port's match program vs the reference's
    make_match_program(refine_impl="conv") on the same frames. Exact
    everywhere the reference defines the output: every row of every valid
    top-K slot and the overflow count, the template id and keep flag of
    every slot. (The conv path sweeps invalid slots' features anyway while
    K4 skips them, as the reference's own Pallas path does, so x/y/
    similarity of invalid slots are not compared; tests/test_pallas_kernels.py
    makes the same cut.)"""
    max_dr = ((ref_bank.max_dr // 16) + 1) * 16
    want = np.asarray(_ref_program(modalities, max_dr)(
        [jnp.asarray(s) for s in ref_sources], ref_bank.kernels_low, ref_bank.kernels_dec,
        (ref_bank.feat_plane, ref_bank.feat_dr, ref_bank.feat_dc, ref_bank.feat_n),
        jnp.asarray(ref_bank.nfeat[0]), jnp.asarray(ref_bank.nfeat[1]),
        jnp.asarray(ref_bank.sizes[0]), jnp.asarray(ref_bank.sizes[1]),
        jnp.float32(thr)))
    run = mp.make_match_program(modalities, (5, 8), (480, 640), DepthNormalParams(),
                                ColorGradientParams(), K_CAP)
    sources = [torch.as_tensor(s if s.dtype == np.uint8 else s.astype(np.int32))
               for s in ref_sources]
    got = run(sources, *mp.bank_args(bank, "cpu"), thr).numpy()
    assert got.shape == want.shape == (2, 5, K_CAP + 1)
    # a top-K slot is valid iff it holds one of the n_above candidates
    n_above = want[:, 0, -1]
    valid_slots = np.concatenate(
        [np.arange(K_CAP)[None] < n_above[:, None], np.ones((2, 1), bool)], 1)
    assert valid_slots[:, :-1].any(), "scenes produced no candidates"
    np.testing.assert_array_equal(np.where(valid_slots[:, None], got, 0),
                                  np.where(valid_slots[:, None], want, 0))
    np.testing.assert_array_equal(got[:, [3, 4]], want[:, [3, 4]])
    assert (got[:, 4, :-1] > 0).any(), "no kept matches"


@pytest.mark.parametrize("thr", [80.0, 70.0])
def test_match_program_equals_reference(golden, thr):
    """Depth-only, on the oracle's match_dnonly scenes."""
    g = golden("match_dnonly")
    ref_bank, bank = _banks(g, ("A", "B"), 2, 1)
    deps = np.stack([g["sceneA_dep"], g["sceneS_dep"]])
    check_match_program(ref_bank, bank, ("DepthNormal",), [deps], thr)


@pytest.mark.parametrize("thr", [80.0, 70.0])
def test_two_modality_match_program_equals_reference(golden, thr):
    """ColorGradient + DepthNormal (K1, K2, K3, K6, K4 twins), on the
    oracle's match_e2e scenes and its two-modality bank."""
    g = golden("match_e2e")
    ref_bank, bank = _banks(g, ("sphA", "sphB"), 4, 2)
    scenes = ("sceneA", "scene2")
    bgrs = np.stack([g[f"{s}_bgr"] for s in scenes])
    deps = np.stack([g[f"{s}_dep"] for s in scenes])
    check_match_program(ref_bank, bank, ("ColorGradient", "DepthNormal"), [bgrs, deps], thr)
