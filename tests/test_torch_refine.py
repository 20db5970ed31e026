"""Port parity: the 16x16 refinement sweep (kernel K4's plain twin) and
the depth-only match program as a whole, against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.core.config import ColorGradientParams
from object_detector_6d_tpu.core.config import DepthNormalParams as RefDNParams
from object_detector_6d_tpu.match import program as ref_mp
from object_detector_6d_tpu.ops.refine_pallas import refine_sweep_batched as ref_sweep
from object_detector_6d_tpu.quant.features import Feature as RefFeature
from object_detector_6d_tpu.quant.features import Template as RefTemplate
from object_detector_6d_tpu_torch.core.config import DepthNormalParams
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


def _banks(g):
    ref_ct, port_ct = {}, {}
    for cid in ("A", "B"):
        r, p = [], []
        for i in range(2):
            w, h, lvl = (int(v) for v in g[f"{cid}_meta{i}"])
            feats = g[f"{cid}_feat{i}"]
            r.append(RefTemplate(w, h, lvl, [RefFeature(int(x), int(y), int(q))
                                             for x, y, q in feats]))
            p.append(Template(w, h, lvl, [Feature(int(x), int(y), int(q))
                                          for x, y, q in feats]))
        ref_ct[cid], port_ct[cid] = [r], [p]
    return ref_mp.pack_bank(ref_ct, 1, 2), mp.pack_bank(port_ct, 1, 2)


@pytest.mark.parametrize("thr", [80.0, 70.0])
def test_match_program_equals_reference(golden, thr):
    """[B, 5, K+1] of the port's depth-only match program vs the
    reference's make_match_program(refine_impl="conv") on the oracle's
    match_dnonly scenes. Exact everywhere the reference defines the
    output: every row of every valid top-K slot and the overflow count,
    the template id and keep flag of every slot. (The conv path sweeps
    invalid slots' features anyway while K4 skips them, as the
    reference's own Pallas path does, so x/y/similarity of invalid slots
    are not compared; tests/test_pallas_kernels.py makes the same cut.)"""
    g = golden("match_dnonly")
    ref_bank, bank = _banks(g)
    deps = np.stack([g["sceneA_dep"], g["sceneS_dep"]])
    K_cap = 16
    max_dr = ((ref_bank.max_dr // 16) + 1) * 16
    prog = ref_mp.make_match_program(
        ("DepthNormal",), (5, 8), (480, 640), RefDNParams(), ColorGradientParams(),
        K_cap, max_dr, refine_impl="conv", batch=2)
    want = np.asarray(prog(
        [jnp.asarray(deps)], ref_bank.kernels_low, ref_bank.kernels_dec,
        (ref_bank.feat_plane, ref_bank.feat_dr, ref_bank.feat_dc, ref_bank.feat_n),
        jnp.asarray(ref_bank.nfeat[0]), jnp.asarray(ref_bank.nfeat[1]),
        jnp.asarray(ref_bank.sizes[0]), jnp.asarray(ref_bank.sizes[1]),
        jnp.float32(thr)))
    run = mp.make_match_program(("DepthNormal",), (5, 8), (480, 640),
                                DepthNormalParams(), K_cap)
    got = run([torch.as_tensor(deps.astype(np.int32))], *mp.bank_args(bank, "cpu"),
              thr).numpy()
    assert got.shape == want.shape == (2, 5, K_cap + 1)
    # a top-K slot is valid iff it holds one of the n_above candidates
    n_above = want[:, 0, -1]
    valid_slots = np.concatenate(
        [np.arange(K_cap)[None] < n_above[:, None], np.ones((2, 1), bool)], 1)
    assert valid_slots[:, :-1].any(), "scenes produced no candidates"
    np.testing.assert_array_equal(np.where(valid_slots[:, None], got, 0),
                                  np.where(valid_slots[:, None], want, 0))
    np.testing.assert_array_equal(got[:, [3, 4]], want[:, [3, 4]])
    assert (got[:, 4, :-1] > 0).any(), "no kept matches"


def test_match_program_rejects_color_gradient():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp.make_match_program(("ColorGradient", "DepthNormal"), (5, 8), (480, 640),
                              DepthNormalParams())
