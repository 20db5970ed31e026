"""Port parity: the coarse sweep (kernel K6's plain twin) against the JAX
package.

Two references. The reference's own ``coarse_sweep`` Pallas kernel
(interpret mode) wraps columns around its power-of-two planes, so it is
compared where no wrap reaches a column. The reference main path's raw
coarse grid is an int8 conv of the decimated level-1 planes with the
bank's one-hot ``kernels_low`` (zero padded): the twin, given the bank's
sparse tables over the modalities' stacked planes, must equal it
everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.match import program as ref_mp
from object_detector_6d_tpu.ops.refine_pallas import coarse_sweep as ref_coarse
from object_detector_6d_tpu.quant.features import Feature as RefFeature
from object_detector_6d_tpu.quant.features import Template as RefTemplate
from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.ops.refine import coarse_sweep
from object_detector_6d_tpu_torch.ops.response import response_spread_batched
from object_detector_6d_tpu_torch.quant.features import Feature, Template

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_coarse_twin_equals_pallas_kernel_where_no_column_wraps(seed):
    rng = np.random.RandomState(seed)
    B, P, Hp, Wp, nT, F, OH = 2, 5, 64, 128, 4, 7, 32
    D = rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8)
    plane = rng.randint(0, P, (nT, F)).astype(np.int32)
    dr = rng.randint(0, Hp - OH - 8, (nT, F)).astype(np.int32)
    dc = rng.randint(0, Wp // 2, (nT, F)).astype(np.int32)
    nfeat = np.array([F, 3, 0, 5], np.int32)
    args = (D, plane, dr, dc, nfeat)
    want = np.asarray(ref_coarse(*(jnp.asarray(a) for a in args), out_h=OH, interpret=True))
    got = coarse_sweep(*(torch.as_tensor(a) for a in args), OH, Wp).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (B, nT, OH, Wp)
    keep = Wp - int(dc.max())  # columns no feature's read wraps into
    np.testing.assert_array_equal(got[..., :keep], want[..., :keep])


def test_coarse_twin_reads_zero_outside_planes():
    """Any plane size; reads past a plane's edge, and features of a plane
    outside 0..P-1, add zero (numpy loop)."""
    rng = np.random.RandomState(3)
    B, P, Hp, Wp, nT, F, OH, OW = 2, 3, 9, 11, 3, 6, 7, 10
    D = rng.randint(0, 5, (B, P, Hp, Wp)).astype(np.int8)
    plane = rng.randint(-1, P + 1, (nT, F)).astype(np.int32)
    dr = rng.randint(0, 5, (nT, F)).astype(np.int32)
    dc = rng.randint(0, 5, (nT, F)).astype(np.int32)
    nfeat = np.array([F, 4, 0], np.int32)
    got = coarse_sweep(*(torch.as_tensor(a) for a in (D, plane, dr, dc, nfeat)), OH, OW)
    pad = np.zeros((B, P, Hp + 8, Wp + 8), np.int32)
    pad[:, :, :Hp, :Wp] = D
    want = np.zeros((B, nT, OH, OW), np.int32)
    for t in range(nT):
        for f in range(nfeat[t]):
            p, r, c = plane[t, f], dr[t, f], dc[t, f]
            if 0 <= p < P:
                want[:, t] += pad[:, p, r:r + OH, c:c + OW]
    np.testing.assert_array_equal(got.numpy(), want)


def _e2e_banks(g):
    ref_ct, port_ct = {}, {}
    for cid in ("sphA", "sphB"):
        r, p = [], []
        for i in range(4):
            w, h, lvl = (int(v) for v in g[f"{cid}_meta{i}"])
            feats = g[f"{cid}_feat{i}"]
            r.append(RefTemplate(w, h, lvl, [RefFeature(int(x), int(y), int(q))
                                             for x, y, q in feats]))
            p.append(Template(w, h, lvl, [Feature(int(x), int(y), int(q))
                                          for x, y, q in feats]))
        ref_ct[cid], port_ct[cid] = [r], [p]
    return ref_mp.pack_bank(ref_ct, 2, 2), mp.pack_bank(port_ct, 2, 2)


@pytest.mark.parametrize("planes", ["scene", "random"])
def test_coarse_twin_equals_reference_int8_conv(golden, planes):
    """The reference main path's raw grid (match/program.py coarse_stage):
    per modality, the int8 conv of the zero-padded decimated level-1
    planes with kernels_low, summed; on the match_e2e bank, with planes
    from the scene's own level-1 responses and with random ones."""
    g = golden("match_e2e")
    ref_bank, bank = _e2e_banks(g)
    t1, H1, W1 = 8, 240, 320
    gh, gw, Hd1, Wd1 = H1 // t1, W1 // t1, -(-H1 // t1), -(-W1 // t1)
    if planes == "scene":
        qs = mp.quantize_pyramids_batched(
            [torch.as_tensor(g["sceneA_bgr"])[None],
             torch.as_tensor(g["sceneA_dep"].astype(np.int32))[None]],
            ("ColorGradient", "DepthNormal"), 2, DepthNormalParams(), ColorGradientParams())
        R1 = [response_spread_batched(q, t1)[0].numpy() for q in qs[1]]
        assert all(q.shape[1:] == (H1, W1) for q in qs[1])
    else:
        R1 = list(np.random.RandomState(4).randint(0, 5, (2, 8, H1, W1)))
    Ds = [R.reshape(8, Hd1, t1, Wd1, t1).transpose(0, 2, 4, 1, 3)
          .reshape(8 * t1 * t1, Hd1, Wd1).astype(np.int8) for R in R1]
    want = 0
    for D, k in zip(Ds, ref_bank.kernels_low):
        kd = k.shape[3]
        Dp = np.pad(D, ((0, 0), (0, max(0, gh + kd - 1 - Hd1)), (0, max(0, gw + kd - 1 - Wd1))))
        want = want + np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(Dp)[None], k, (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.int32))[0, :, :gh, :gw]
    tables = [torch.as_tensor(a) for a in bank.coarse]
    got = coarse_sweep(torch.as_tensor(np.concatenate(Ds))[None], *tables, gh, gw)[0]
    assert got.shape == want.shape == (2, gh, gw)
    assert want.max() > 0
    np.testing.assert_array_equal(got.numpy(), want)
