"""The port's inexact float32 functions, with the same bits on every device.

A float32 ``sqrt``, ``sin``, ``cos``, ``exp``, ``atan2`` or ``arccos``
is computed by each device's own approximation: PyTorch's CPU ``sqrt``
is an ulp off on ~0.7% of inputs, its ``cos`` on ~5%, and CUDA's
float32 ``sin`` / ``cos`` / ``exp`` are within 2 ulp, so the card and
the CPU gave different answers on the same inputs. Every helper here
returns the correctly rounded float32 result, which has one value on
every device:

* the input goes to float64, the float64 function runs and its result is
  rounded to float32. For ``sqrt`` that is provably correctly rounded
  (float64 carries more than 2 * 24 + 2 bits; the float64 sqrt is the
  IEEE one: the card's, and on the CPU numpy's, since PyTorch's CPU
  float64 sqrt is not correctly rounded); for the others the float64
  result is within an ulp or two of float64, so its rounding to float32
  is correct except within ~2^-28 of a float32 midpoint;
* where a device's own float32 operation is already correctly rounded,
  the helper calls it directly and saves the two casts: CUDA's float32
  ``sqrt`` compiles to IEEE ``sqrt.rn`` (``_NATIVE``, a fixed table;
  chip_smoke.py checks it on all 2^31 positive float32 values).

The norms and small products are written as explicit operations, so
that each device takes one order: ``norm3`` is sqrt(fma(z, z, fma(y, y,
x * x))), the order of PyTorch's CPU ``vector_norm`` over 3 entries and
of XLA:CPU's ``jnp.linalg.norm``; ``norm4`` is sqrt(((x*x + y*y) + z*z)
+ w*w), the CPU ``vector_norm``'s order over 4; ``fma_matmul`` is the
fma chain of the CPU's ``matmul`` and XLA:CPU's ``dot`` over a small
inner axis. An fma is emulated exactly in float64 (``fma_rn``); ``dot3``
is (a0 b0 + a1 b1) + a2 b2.

``eigh3`` replaces ``torch.linalg.eigh`` for 3x3 symmetric matrices:
each device's library takes its own order (LAPACK on the CPU, cuSOLVER
on the card), so their eigenvectors parted in the last bits. Its cyclic
Jacobi runs in float64 with a fixed number of sweeps, every operation
one elementwise IEEE operation, and rounds once to float32. ``div_rn``
divides by a tensor only (a CUDA tensor divided by a Python scalar is
a product with the scalar's float32 reciprocal, unlike the CPU).

``sincos_device`` is the one exception, each device's own pair, kept
for the host fallback's nearest-neighbour ICP (its docstring says why).
"""

from __future__ import annotations

import numpy as np
import torch

# device types whose own float32 and float64 op is correctly rounded, by
# function
_NATIVE = {"sqrt": ("cuda",)}


def _via_f64(fn, *xs: torch.Tensor) -> torch.Tensor:
    return fn(*(x.double() for x in xs)).to(xs[0].dtype)


def _sqrt64_host(x: torch.Tensor) -> torch.Tensor:
    """IEEE float64 sqrt of a CPU tensor, numpy's (the hardware's):
    PyTorch's CPU float64 sqrt is an ulp off on ~0.8% of inputs."""
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt (float32 or float64)."""
    if x.device.type in _NATIVE["sqrt"]:
        return torch.sqrt(x)
    if x.dtype == torch.float64:
        return _sqrt64_host(x)
    return _sqrt64_host(x.double()).to(x.dtype)


def sincos_rn(x: torch.Tensor):
    """(sin x, cos x), correctly rounded, from one cast to float64."""
    d = x.double()
    return torch.sin(d).to(x.dtype), torch.cos(d).to(x.dtype)


def sincos_device(x: torch.Tensor):
    """(sin x, cos x) by the device's own float32 functions: NOT the same
    bits on every device. Only the host fallback's nearest-neighbour ICP
    (refine/icp.py) takes it: its result is chaotic at the ulp level, and
    with the correctly rounded pair one objA pose of the parity set
    ``two`` lands 1.69 mm from the JAX reference's, against 0.17 mm with
    the CPU's own functions (tests/test_torch_fallback.py holds 1 mm)."""
    return torch.sin(x), torch.cos(x)


def sin_rn(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.sin, x)


def cos_rn(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.cos, x)


def exp_rn(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.exp, x)


def arccos_rn(x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.arccos, x)


def atan2_rn(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _via_f64(torch.atan2, y, x)


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 values given as float64 tensors, rounded to
    float32 exactly once.

    a * b is exact in float64; the sum s = a * b + c is not always, and a
    second rounding to float32 could then go the wrong way when s lands on
    a float32 midpoint. So s is made round-to-odd: its error e (TwoSum) is
    nonzero only when s is inexact, and then s is moved to the odd float64
    neighbour on the exact sum's side; a round-to-odd float64 value rounds
    to float32 as the exact sum does."""
    p = a * b
    s = p + c
    pp = s - c
    e = (p - pp) + (c - (s - pp))
    bits = s.view(torch.int64)
    fix = ((e > 0) | (e < 0)) & ((bits & 1) == 0)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to float32 (an IEEE fused multiply-add)."""
    return _fma64(a.double(), b.double(), c.double())


def fma_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [..., m, k] @ B [..., k, n] for a small k as a chain of fmas,
    acc = fma(A[:, j], B[j], acc) for j = 1 .. k-1 from A[:, 0] * B[0]: the
    order of PyTorch's CPU ``matmul`` and XLA:CPU's ``dot`` at these sizes."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for j in range(1, A.shape[-1]):
        acc = fma_rn(A[..., :, j:j + 1], B[..., j:j + 1, :], acc)
    return acc


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over a last axis of 3 entries: (a0 b0 + a1 b1) + a2 b2, the
    CPU ``torch.sum``'s order, written out so that the card takes it too."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a 3-entry axis: sqrt(fma(z, z, fma(y, y, x * x)))."""
    x0, x1, x2 = x.unbind(dim)
    d1, d2 = x1.double(), x2.double()
    acc = _fma64(d1, d1, (x0 * x0).double())
    acc = _fma64(d2, d2, acc.double())
    out = sqrt_rn(acc)
    return out.unsqueeze(dim) if keepdim else out


def norm4(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over a 4-entry axis: sqrt(((x*x + y*y) + z*z) + w*w)."""
    x0, x1, x2, x3 = x.unbind(dim)
    out = sqrt_rn(((x0 * x0 + x1 * x1) + x2 * x2) + x3 * x3)
    return out.unsqueeze(dim) if keepdim else out


# cyclic Jacobi sweeps of eigh3: the off-diagonal shrinks quadratically
# once it is small; 6 sweeps take any float32 input to float64 round-off
# (tests/test_torch_exact_math.py), with no test for convergence
EIGH3_SWEEPS = 6


def div_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b for two tensors: one IEEE division on every device (a CUDA
    tensor divided by a Python scalar is a product with the scalar's
    float32 reciprocal instead)."""
    if not isinstance(b, torch.Tensor):
        raise TypeError("div_rn divides by a tensor")
    return a / b


def eigh3(A: torch.Tensor):
    """Eigen-decomposition of symmetric 3x3 matrices A [..., 3, 3] ->
    (eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3] as columns),
    in A's dtype, the same bits on every device.

    A cyclic Jacobi in float64 over the pairs (0, 1), (0, 2), (1, 2),
    EIGH3_SWEEPS times: each rotation zeroes a[p, q] with t = sign(h) /
    (|h| + sqrt(h^2 + 1)), h = (a[q, q] - a[p, p]) / (2 a[p, q]) (t = 0 where
    a[p, q] is 0), c = 1 / sqrt(t^2 + 1), s = t c. Only the upper triangle
    is read. The eigenvalues are sorted by a stable sort (equal values keep
    their diagonal order); each column's sign is the rotations'."""
    a = A.double()
    m = {(i, j): a[..., i, j] for i in range(3) for j in range(i, 3)}
    one = torch.ones_like(m[0, 0])
    zero = torch.zeros_like(one)
    v = {(i, j): one if i == j else zero for i in range(3) for j in range(3)}

    def get(i, j):
        return m[(i, j) if i <= j else (j, i)]

    def put(i, j, x):
        m[(i, j) if i <= j else (j, i)] = x

    for _ in range(EIGH3_SWEEPS):
        for p, q, r in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            apq, app, aqq = get(p, q), get(p, p), get(q, q)
            off = apq == 0
            h = div_rn(aqq - app, torch.where(off, one, apq + apq))
            root = sqrt_rn(h * h + one)
            t = div_rn(torch.where(h < 0, -one, one), torch.abs(h) + root)
            t = torch.where(off, zero, t)
            c = div_rn(one, sqrt_rn(t * t + one))
            s = t * c
            tapq = t * apq
            put(p, p, app - tapq)
            put(q, q, aqq + tapq)
            put(p, q, zero)
            arp, arq = get(r, p), get(r, q)
            put(r, p, c * arp - s * arq)
            put(r, q, s * arp + c * arq)
            for k in range(3):
                vkp, vkq = v[k, p], v[k, q]
                v[k, p] = c * vkp - s * vkq
                v[k, q] = s * vkp + c * vkq
    evals = torch.stack([m[0, 0], m[1, 1], m[2, 2]], -1)
    evals, order = torch.sort(evals, dim=-1, stable=True)
    vecs = torch.stack([torch.stack([v[k, j] for j in range(3)], -1) for k in range(3)], -2)
    vecs = torch.gather(vecs, -1, order[..., None, :].expand(vecs.shape))
    return evals.to(A.dtype), vecs.to(A.dtype)
