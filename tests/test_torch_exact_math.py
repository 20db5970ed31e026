"""The port's inexact float32 calls (core/exact.py) and fixed-order sums
against numpy models, and the rule that keeps every such call there.

Each helper returns the correctly rounded float32 result, which is the
same on every device: numpy's float64 function rounded to float32 is the
model (sqrt provably; the others agree on every input tried). ``norm3``
and ``fma_matmul`` are XLA:CPU's and PyTorch's CPU orders written out,
so they equal ``jnp.linalg.norm``, ``vector_norm`` and ``matmul`` on the
CPU; ``fma_rn`` is an exact fused multiply-add, held against rational
arithmetic. The detect path's solve, Rodrigues map and cluster sums are
held bitwise against numpy float32 models of the same operations, and
``eigh3`` (the 3x3 symmetric eigensolver of planes and PPF's normals)
against a numpy float64 model of its Jacobi sweeps, bitwise, and against
LAPACK's ``eigh``.
"""

import fractions
import io
import pathlib
import re
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu_torch.api import detect_program as dp
from object_detector_6d_tpu_torch.core import exact
from object_detector_6d_tpu_torch.core import se3
from object_detector_6d_tpu_torch.core.reduce import fixed_sum
from object_detector_6d_tpu_torch.refine.projective import _chol_solve6

PKG = pathlib.Path(exact.__file__).resolve().parent.parent
F32 = np.float32
N = 1 << 20
SPECIAL = np.array([0.0, -0.0, 1e-45, 1e-40, -1e-40, 1.17549435e-38, np.inf, -np.inf, np.nan,
                    1e-32, 1e-20, 1e4, -1e4, 1.0, -1.0], F32)


def _bits(x) -> np.ndarray:
    """float32 bits with every NaN as one value (NaN == NaN)."""
    x = np.ascontiguousarray(np.asarray(x, F32))
    return np.where(np.isnan(x), np.int32(0x7FC00000), x.view(np.int32))


def _inputs(seed: int, lo: float, hi: float) -> np.ndarray:
    """N seeded float32 values: half uniform over [lo, hi], half of random
    bits inside it (every exponent, subnormals), plus the special values."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(lo, hi, N // 2).astype(F32)
    b = rng.integers(0, 1 << 32, N // 2, dtype=np.int64).astype(np.uint32).view(F32)
    b = b[np.isfinite(b) & (b >= lo) & (b <= hi)]
    return np.concatenate([u, b, SPECIAL])


@pytest.mark.parametrize("name, fn, lo, hi", [
    ("sqrt_rn", np.sqrt, 0.0, 1e4),
    ("exp_rn", np.exp, -120.0, 1e4),
    ("arccos_rn", np.arccos, -1.0, 1.0),
])
def test_unary_helper_is_float64_rounded(name, fn, lo, hi):
    x = _inputs(1, lo, hi)
    with np.errstate(all="ignore"):
        want = fn(x.astype(np.float64)).astype(F32)
    got = getattr(exact, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sincos_is_float64_rounded():
    x = np.concatenate([_inputs(2, -1e4, 1e4), -_inputs(3, 0.0, 7.0)])
    s, c = exact.sincos_rn(torch.from_numpy(x))
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(np.sin(x.astype(np.float64))))
        np.testing.assert_array_equal(_bits(c.numpy()), _bits(np.cos(x.astype(np.float64))))
    np.testing.assert_array_equal(exact.sin_rn(torch.from_numpy(x)).numpy(), s.numpy())
    np.testing.assert_array_equal(exact.cos_rn(torch.from_numpy(x)).numpy(), c.numpy())


def test_atan2_is_float64_rounded():
    rng = np.random.default_rng(4)
    y = np.concatenate([rng.standard_normal(N).astype(F32), SPECIAL, SPECIAL])
    x = np.concatenate([rng.standard_normal(N).astype(F32), SPECIAL, SPECIAL[::-1]])
    got = exact.atan2_rn(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sqrt_equals_xla():
    """On every normal float32 and +-0 (XLA:CPU flushes subnormal inputs
    to zero, where sqrt_rn, numpy and the card keep them)."""
    x = _inputs(5, 0.0, 3.4e38)
    x = x[(np.abs(x) >= np.finfo(F32).tiny) | (x == 0) | ~np.isfinite(x)]
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    np.testing.assert_array_equal(_bits(exact.sqrt_rn(torch.from_numpy(x)).numpy()), _bits(want))


def test_card_route_is_static():
    """The card takes its own float32 sqrt (IEEE sqrt.rn, checked on all
    2^31 non-negative float32 values by chip_smoke.py phase 17); every
    other helper, and the CPU, takes the float64 route."""
    assert exact._NATIVE == {"sqrt": ("cuda",)}


def _round_f32(q: fractions.Fraction) -> np.float32:
    """The float32 nearest to the rational q (ties to even), exactly."""
    f = F32(float(q))
    if not np.isfinite(f) or fractions.Fraction(float(f)) == q:
        return f
    lo, hi = (f, np.nextafter(f, F32(np.inf))) if fractions.Fraction(float(f)) < q else \
        (np.nextafter(f, F32(-np.inf)), f)
    dlo = q - fractions.Fraction(float(lo))
    dhi = fractions.Fraction(float(hi)) - q
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_fma_is_exact():
    rng = np.random.default_rng(6)
    n = 20000
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-10, 4, n)).astype(F32)
    b = (rng.standard_normal(n) * 10.0 ** rng.uniform(-10, 4, n)).astype(F32)
    c = (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 8, n)).astype(F32)
    # a product on a float32 midpoint plus a tiny c: one rounding goes up,
    # float64 then float32 would round down to the even neighbour
    a[:4] = b[:4] = F32(1 + 2.0 ** -12)
    c[:4] = [2.0 ** -60, -2.0 ** -60, 0.0, 2.0 ** -149]
    got = exact.fma_rn(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                                + fractions.Fraction(float(z))) for x, y, z in zip(a, b, c)], F32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] == F32(1 + 2.0 ** -11 + 2.0 ** -23) != F32(
        np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))


def _vectors(seed: int, width: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((N, width)) * 10.0 ** rng.uniform(-8, 4, (N, 1))
    v[:8] = 0.0
    v[1, 0], v[2, 1], v[3, 2] = 1e-40, -1e4, 1e-20
    return v.astype(F32)


def test_norm3_equals_xla_and_vector_norm():
    v = _vectors(7, 3)
    got = exact.norm3(torch.from_numpy(v)).numpy()
    # XLA:CPU flushes subnormal values to zero: held on the other rows
    normal = ((np.abs(v) >= np.sqrt(np.finfo(F32).tiny)) | (v == 0)).all(-1)
    np.testing.assert_array_equal(got[normal], np.asarray(jax.jit(
        lambda a: jnp.linalg.norm(a, axis=-1))(v))[normal])
    assert normal.mean() > 0.99
    np.testing.assert_array_equal(got, torch.linalg.vector_norm(torch.from_numpy(v), dim=-1))
    kept = exact.norm3(torch.from_numpy(v.T.copy()), dim=0, keepdim=True).numpy()
    np.testing.assert_array_equal(kept[0], got)


def test_norm4_equals_vector_norm():
    v = _vectors(8, 4)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(exact.norm4(t).numpy(),
                                  torch.linalg.vector_norm(t, dim=-1).numpy())
    s = ((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]) + v[:, 3] * v[:, 3]
    np.testing.assert_array_equal(exact.norm4(t).numpy(), np.sqrt(s))


def test_fma_matmul_equals_cpu_matmul_and_xla():
    rng = np.random.default_rng(9)
    pts = (rng.standard_normal((N // 4, 3)) * 2.0).astype(F32)
    R = se3.SE3.exp(torch.tensor([0.05, -0.03, 0.02, 0.0, 0.0, 0.0])).numpy()[:3, :3]
    got = exact.fma_matmul(torch.from_numpy(pts), torch.from_numpy(R.T.copy())).numpy()
    np.testing.assert_array_equal(got, torch.matmul(torch.from_numpy(pts),
                                                    torch.from_numpy(R.T.copy())).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda a, b: jnp.matmul(
        a, b.T, precision=jax.lax.Precision.HIGHEST))(pts, R)))


# ----------------------------------------------------------------------
# the detect path's solve, Rodrigues map and cluster sums, as numpy models
# ----------------------------------------------------------------------

def _np_fixed_sum(x: np.ndarray, axis: int) -> np.ndarray:
    """core/reduce.py fixed_sum in numpy: zero-pad to a power of two, then
    add the upper half to the lower half until one entry is left."""
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0]
    size = 1 << max(0, (n - 1).bit_length())
    x = np.concatenate([x, np.zeros((size - n,) + x.shape[1:], x.dtype)])
    while size > 1:
        size //= 2
        x = x[:size] + x[size:]
    return x[0]


def _np_chol_solve6(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """_chol_solve6 step by step in numpy float32, np.sqrt for the root."""
    lam = F32(1e-6) * (((((A[:, 0, 0] + A[:, 1, 1]) + A[:, 2, 2]) + A[:, 3, 3]) + A[:, 4, 4])
                       + A[:, 5, 5]) + F32(1e-12)
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = A[:, j, j] + lam
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = np.sqrt(np.maximum(s, F32(1e-20)))
        inv = F32(1.0) / L[j][j]
        for i in range(j + 1, 6):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return np.stack(x, -1)


def test_chol_solve6_equals_numpy_model():
    rng = np.random.default_rng(10)
    L = 4096
    J = (rng.standard_normal((L, 24, 6)) * 10.0 ** rng.uniform(-3, 1, (L, 1, 6))).astype(F32)
    A = np.einsum("lni,lnj->lij", J.astype(np.float64), J.astype(np.float64)).astype(F32)
    A[:8] = -np.eye(6, dtype=F32)  # a negative pivot: the 1e-20 clamp
    b = rng.standard_normal((L, 6)).astype(F32)
    got = _chol_solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(_bits(got), _bits(_np_chol_solve6(A, b)))


def _sym3(rng, n: int) -> np.ndarray:
    """n seeded symmetric float32 3x3 matrices: random ones over nine
    decades of scale, and R diag(d) R^T with two eigenvalues 1e-7..1e-1
    apart (near-degenerate, as a flat neighbourhood gives)."""
    M = rng.standard_normal((n, 3, 3))
    A = (M + M.transpose(0, 2, 1)) * 10.0 ** rng.uniform(-6, 3, (n, 1, 1))
    R = np.linalg.qr(rng.standard_normal((n, 3, 3)))[0]
    d = np.stack([np.ones(n), 1 + 10.0 ** rng.uniform(-7, -1, n), rng.uniform(-3, 3, n)], -1)
    Q = (R * d[:, None, :]) @ R.transpose(0, 2, 1)
    A[n // 2:] = ((Q + Q.transpose(0, 2, 1)) / 2)[n // 2:]
    A[:4] = np.diag([2.0, 1.0, 1.0])  # already diagonal, a tie: stable order
    return A.astype(F32)


def _np_eigh3(A: np.ndarray):
    """eigh3's cyclic Jacobi in numpy float64, operation by operation."""
    a = A.astype(np.float64)
    m = {(i, j): a[:, i, j].copy() for i in range(3) for j in range(i, 3)}
    one, zero = np.ones(len(A)), np.zeros(len(A))
    v = {(i, j): one if i == j else zero for i in range(3) for j in range(3)}
    key = lambda i, j: (i, j) if i <= j else (j, i)  # noqa: E731
    with np.errstate(all="ignore"):
        for _ in range(exact.EIGH3_SWEEPS):
            for p, q, r in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
                apq, app, aqq = m[p, q], m[p, p], m[q, q]
                off = apq == 0
                h = (aqq - app) / np.where(off, one, apq + apq)
                t = np.where(h < 0, -one, one) / (np.abs(h) + np.sqrt(h * h + one))
                t = np.where(off, zero, t)
                c = one / np.sqrt(t * t + one)
                s = t * c
                m[p, p], m[q, q], m[p, q] = app - t * apq, aqq + t * apq, zero
                arp, arq = m[key(r, p)], m[key(r, q)]
                m[key(r, p)], m[key(r, q)] = c * arp - s * arq, s * arp + c * arq
                for k in range(3):
                    v[k, p], v[k, q] = c * v[k, p] - s * v[k, q], s * v[k, p] + c * v[k, q]
    w = np.stack([m[0, 0], m[1, 1], m[2, 2]], -1)
    order = np.argsort(w, -1, kind="stable")
    V = np.stack([np.stack([v[k, j] for j in range(3)], -1) for k in range(3)], -2)
    return (np.take_along_axis(w, order, -1).astype(F32),
            np.take_along_axis(V, order[:, None, :], -1).astype(F32))


def test_eigh3_equals_numpy_model_and_numpy_eigh():
    A = _sym3(np.random.default_rng(12), 1 << 16)
    w, V = (x.numpy() for x in exact.eigh3(torch.from_numpy(A)))
    # every operation one IEEE float64 operation: the numpy model's bits
    want_w, want_V = _np_eigh3(A)
    np.testing.assert_array_equal(_bits(w), _bits(want_w))
    np.testing.assert_array_equal(_bits(V), _bits(want_V))
    # against LAPACK in float64: eigenvalues within an ulp of the largest,
    # ascending; the smallest one's eigenvector within 1e-6 rad where its
    # gap is over 1e-3 of the largest
    ref_w, ref_V = np.linalg.eigh(A.astype(np.float64))
    big = np.abs(ref_w).max(-1)
    assert (np.abs(w - ref_w).max(-1) <= np.spacing(big.astype(F32))).all()
    assert (np.diff(w, axis=-1) >= 0).all()
    gap = (ref_w[:, 1] - ref_w[:, 0]) / big > 1e-3
    v0 = V[:, :, 0].astype(np.float64)
    cos = np.abs((v0 * ref_V[:, :, 0]).sum(-1)) / np.linalg.norm(v0, axis=-1)
    assert gap.mean() > 0.8
    assert np.arccos(np.minimum(cos[gap], 1.0)).max() < 1e-6
    # orthonormal columns
    np.testing.assert_allclose(np.einsum("nki,nkj->nij", V.astype(np.float64), V),
                               np.broadcast_to(np.eye(3), V.shape), rtol=0, atol=1e-6)


def test_eigh3_does_not_depend_on_batch_position():
    A = _sym3(np.random.default_rng(13), 4096)
    perm = np.random.default_rng(14).permutation(len(A))
    w, V = exact.eigh3(torch.from_numpy(A))
    w_p, V_p = exact.eigh3(torch.from_numpy(A[perm]))
    assert torch.equal(w_p, w[perm]) and torch.equal(V_p, V[perm])
    one_w, one_V = exact.eigh3(torch.from_numpy(A[5:6]))
    assert torch.equal(one_w, w[5:6]) and torch.equal(one_V, V[5:6])


def test_so3_exp_equals_numpy_model():
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((N // 8, 3)) * 10.0 ** rng.uniform(-9, 0.5, (N // 8, 1))).astype(F32)
    w[:4] = 0.0
    # fixed_sum over 3 entries: the pad's zero added to the middle one
    theta2 = (w[:, 0] * w[:, 0] + w[:, 2] * w[:, 2]) + (w[:, 1] * w[:, 1] + F32(0.0))
    theta = np.sqrt(theta2 + F32(1e-32))
    small = theta2 < F32(1e-12)
    with np.errstate(all="ignore"):
        sin = np.sin(theta.astype(np.float64)).astype(F32)
        cos = np.cos(theta.astype(np.float64)).astype(F32)
        a = np.where(small, F32(1.0) - theta2 * F32(se3._SIXTH), sin / theta)
        b = np.where(small, F32(0.5) - theta2 * F32(se3._TWENTY_FOURTH),
                     (F32(1.0) - cos) / theta2)
    W = se3.hat(torch.from_numpy(w)).numpy()
    p = W[:, :, :, None] * W[:, None, :, :]
    WW = (p[:, :, 0] + p[:, :, 2]) + (p[:, :, 1] + F32(0.0))
    want = (np.eye(3, dtype=F32) + a[:, None, None] * W) + b[:, None, None] * WW
    np.testing.assert_array_equal(_bits(se3.so3_exp(torch.from_numpy(w)).numpy()), _bits(want))


def test_cluster_sums_are_numpy_fixed_sums(monkeypatch):
    """Every float sum of the cluster stage on a seeded raw tuple is a
    fixed_sum whose bits equal the numpy tree on the same input; the stage
    itself (qq, the member sums, the quaternion means) takes no other."""
    seen = []

    def checked(x, dim):
        out = fixed_sum(x, dim)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(_np_fixed_sum(x.numpy(), dim)))
        seen.append(tuple(x.shape))
        return out

    monkeypatch.setattr(dp, "fixed_sum", checked)
    monkeypatch.setattr(se3, "fixed_sum", checked)
    rng = np.random.default_rng(12)
    B, K = 3, 16
    packed = np.zeros((B, 5, K + 1), F32)
    packed[:, 0, :K] = rng.integers(0, 600, (B, K))
    packed[:, 1, :K] = rng.integers(0, 440, (B, K))
    packed[:, 2, :K] = rng.integers(80, 100, (B, K)).astype(F32) + F32(0.25)
    packed[:, 3, :K] = rng.integers(0, 4, (B, K))
    packed[:, 4, :K] = 1.0
    packed[:, 0, K] = K
    w = rng.standard_normal((B, K, 3)).astype(F32) * F32(0.1)
    w[:, K // 2:] = w[:, :K // 2] + F32(0.01)  # near-duplicates: clusters of two
    poses = np.tile(np.eye(4, dtype=F32), (B, K, 1, 1))
    poses[..., :3, :3] = se3.so3_exp(torch.from_numpy(w)).numpy()
    poses[..., :3, 3] = rng.uniform(-0.05, 0.05, (B, 1, 3)).astype(F32) + \
        rng.uniform(-0.002, 0.002, (B, K, 3)).astype(F32)
    res = rng.uniform(0.0, 0.004, (B, K)).astype(F32)
    keep = np.ones((B, K), bool)
    keep[0, 3] = False
    stage = dp.make_cluster_stage(K)
    flat = stage(*(torch.from_numpy(a) for a in (packed, poses, res, keep)),
                 torch.tensor([0, 0, 1, 1]), 0.006, 0.02)
    slots = flat[:, :K * dp.CLUSTER_SLOT].reshape(B, K, dp.CLUSTER_SLOT)
    assert (slots[..., 7] >= 2).any()  # some cluster averages two members
    sizes = sorted(set(seen))
    assert {(B, K, 4, K), (B, K, K), (B, K, K, 4), (B, K, K, 3)} <= set(sizes), sizes


# ----------------------------------------------------------------------
# the rule: every inexact float32 call of the port is core/exact.py's
# ----------------------------------------------------------------------

INEXACT = re.compile(r"\btorch \. (sqrt|rsqrt|sin|cos|tan|exp|expm1|log|log1p|atan2|arctan2|"
                     r"arccos|acos|arcsin|asin|pow|hypot|norm) \(|\. (sqrt|rsqrt|sin|cos|exp|log) "
                     r"\( \)|vector_norm|torch \. linalg \. (norm|eigh|eigvalsh|eig|solve) \(")
# (numpy calls run on the host whatever the device, so they give one answer)
# file -> why it may call the device's own functions
INEXACT_ALLOWED = {
    "core/exact.py": "the helpers themselves (and sincos_device, the host fallback's "
                     "nearest-neighbour ICP's own pair, kept there with its reason)",
}
# float sums in the files test_detect_sums_are_fixed_order reads (lift +
# ICP, the cluster stage, planes, PPF's normals, the host fallback's ICP)
# that are exact in any order or kept for a reason: (file, line text) -> why
SUM = re.compile(r"\. sum \(|\. matmul \(|\. mean \(|\S @ ")
SUM_ALLOWED = {
    ("api/detect_program.py", "cnt = Mf.sum(-1)"): "0/1 member counts",
    ("api/detect_program.py", "votes_tot = (M * votes_s[:, None, :]).sum(-1)"): "integer votes",
    ("api/detect_program.py", "valid.sum(1).to(f32)"): "a count of booleans",
    ("api/detect_program.py", "n = finf.sum(-1)"): "0/1 finite counts",
    ("api/detect_program.py", "<= pos[..., :, None]).sum(-1)"): "a count of booleans",
    ("api/detect_program.py", "torch.isfinite(models[..., 0]).sum(-1)"): "a count of booleans",
    ("refine/projective.py", "torch.sum(w, dim=-1)"): "0/1 inlier weights",
    ("geom/plane.py", "w.sum(-1)"): "0/1 finite counts",
    ("geom/plane.py", "(ns @ ref)"): "numpy on the host, one answer on every device",
    ("geom/plane.py", "ns.mean(0)"): "numpy on the host",
    ("geom/plane.py", "mean[members].mean(0)"): "numpy on the host",
    ("ppf/helpers.py", "pc[:, :3] @ pose[:3, :3].T"): "numpy on the host",
    ("ppf/helpers.py", "pc[:, 3:6] @ pose[:3, :3].T"): "numpy on the host",
    ("refine/icp.py", "(~torch.isnan(a)).sum(-1, keepdim=True)"): "a count of booleans",
}


def _tokens(readline):
    """{line number: the line's code without strings and comments, its
    tokens joined by single spaces}."""
    lines = {}
    for tok in tokenize.generate_tokens(readline):
        if tok.type not in (tokenize.STRING, tokenize.COMMENT, tokenize.NL,
                            tokenize.NEWLINE, tokenize.INDENT, tokenize.DEDENT):
            lines.setdefault(tok.start[0], []).append(tok.string)
    return {i: " ".join(t) for i, t in lines.items()}


def _code_lines(path: pathlib.Path):
    """(line number, the line's code without strings and comments)."""
    with path.open() as f:
        return sorted(_tokens(f.readline).items())


def test_inexact_calls_only_in_exact():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if rel in INEXACT_ALLOWED:
            continue
        found += [f"{rel}:{i}: {code.strip()}" for i, code in _code_lines(path)
                  if INEXACT.search(code)]
    assert not found, "\n".join(found)


def test_detect_sums_are_fixed_order():
    files = ("api/detect_program.py", "refine/projective.py", "core/se3.py", "core/reduce.py",
             "geom/plane.py", "ppf/helpers.py", "refine/icp.py")
    found = []
    for rel in files:
        for i, code in _code_lines(PKG / rel):
            if SUM.search(code) and not any(
                    f == rel and _tokens(io.StringIO(text).readline)[1] in code
                    for f, text in SUM_ALLOWED):
                found.append(f"{rel}:{i}: {code.strip()}")
    assert not found, "\n".join(found)
