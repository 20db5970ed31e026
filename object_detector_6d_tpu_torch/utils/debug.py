"""Debug-mode numeric discipline (port of object_detector_6d_tpu/utils/debug.py).

Two failure classes matter in a pipeline that threads NaN through as
the masked-invalid value: out-of-range indices (a device-side assert on
a card poisons the CUDA context), and NaN escaping that convention
(legal inside the programs, a bug in a kept output pose). Two opt-in
tools, free when off:

* ``checked(fn, checks)``: runs ``fn`` under a
  ``torch.overrides.TorchFunctionMode`` that checks every torch call:
  an index out of range ("index", checked before the op launches), a
  zero divisor ("div"), and a NaN produced from inputs that had none
  ("nan"). The first violation raises ``CheckError``. Each check syncs
  the host: use it in tests and while debugging.
* ``nan_watch(x, name, mask)``: prints a warning when ``x`` holds NaN,
  but ONLY while debug mode is on (``ODT_DEBUG=1`` or :func:`enable`);
  otherwise it returns ``x`` at once, with no sync. The fused detect
  program watches its kept output poses this way.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Sequence

import torch
from torch.overrides import TorchFunctionMode

_ENABLED = os.environ.get("ODT_DEBUG", "") not in ("", "0")

_CHECKS = ("index", "nan", "div")
# ops whose second argument (or ``other``) is a divisor
_DIV_OPS = {"div", "div_", "true_divide", "true_divide_", "floor_divide", "floor_divide_",
            "remainder", "remainder_", "fmod", "fmod_", "__truediv__", "__itruediv__",
            "__floordiv__", "__ifloordiv__", "__mod__", "__imod__"}
# ops that read or write ``input`` at ``index`` along ``dim``
_DIM_INDEX_OPS = {"gather", "take_along_dim", "index_select", "scatter", "scatter_",
                  "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
                  "index_add", "index_add_", "index_copy", "index_copy_", "index_fill",
                  "index_fill_"}


class CheckError(RuntimeError):
    """A ``checked`` run met an out-of-range index, a zero divisor or a
    NaN made by an op."""


def enable(on: bool = True) -> None:
    """Turn the debug watches on or off (from the next call on)."""
    global _ENABLED
    _ENABLED = on


def debug_enabled() -> bool:
    return _ENABLED


def _name(func) -> str:
    return getattr(func, "__name__", str(func))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _has_nan(x) -> bool:
    return any(t.is_floating_point() and bool(torch.isnan(t).any()) for t in _tensors(x))


def _check_range(name, idx: torch.Tensor, size: int, allow_negative: bool) -> None:
    if idx.numel() == 0:
        return
    lo, hi = int(idx.min()), int(idx.max())
    if hi >= size or lo < (-size if allow_negative else 0):
        raise CheckError(f"out-of-bounds index in {name}: index range [{lo}, {hi}] "
                         f"for a dimension of size {size}")


def _check_getitem(name, x: torch.Tensor, key) -> None:
    """Integer-tensor indices of x[key] / x[key] = v against their dims."""
    key = key if isinstance(key, tuple) else (key,)
    n_ell = sum(k is Ellipsis for k in key)
    used = sum(k.dim() if isinstance(k, torch.Tensor) and k.dtype == torch.bool else 1
               for k in key if k is not None and k is not Ellipsis)
    dim = 0
    for k in key:
        if k is None:
            continue
        if k is Ellipsis:
            dim += x.dim() - used if n_ell else 0
            continue
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            dim += k.dim()
            continue
        if isinstance(k, torch.Tensor) and not k.is_floating_point():
            _check_range(name, k, x.shape[dim], allow_negative=True)
        dim += 1


def _check_index(name, args, kwargs) -> None:
    if name in ("__getitem__", "__setitem__") and isinstance(args[0], torch.Tensor):
        _check_getitem(name, args[0], args[1])
    elif name in _DIM_INDEX_OPS:
        x = kwargs.get("input", args[0] if args else None)
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        index = kwargs.get("index", args[2] if len(args) > 2 else None)
        if isinstance(x, torch.Tensor) and isinstance(index, torch.Tensor) and dim is not None:
            _check_range(name, index, x.shape[dim], allow_negative=False)
    elif name == "take":
        x, index = args[0], kwargs.get("index", args[1] if len(args) > 1 else None)
        if isinstance(index, torch.Tensor):
            _check_range(name, index, x.numel(), allow_negative=True)


def _check_div(name, args, kwargs) -> None:
    if name not in _DIV_OPS:
        return
    other = kwargs.get("other", args[1] if len(args) > 1 else None)
    if isinstance(other, torch.Tensor):
        zero = bool((other == 0).any())
    else:
        zero = other == 0
    if zero:
        raise CheckError(f"division by zero in {name}")


class _CheckMode(TorchFunctionMode):
    def __init__(self, checks: Sequence[str]):
        super().__init__()
        self.checks = frozenset(checks)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if "index" in self.checks:
            _check_index(name, args, kwargs)
        if "div" in self.checks:
            _check_div(name, args, kwargs)
        nan_in = "nan" in self.checks and _has_nan((args, kwargs))
        out = func(*args, **kwargs)
        if "nan" in self.checks and not nan_in and _has_nan(out):
            raise CheckError(f"nan generated by {name}")
        return out


def checked(fn: Callable, checks: Sequence[str] = ("index", "nan")) -> Callable:
    """``fn`` run under the checks named (any of "index", "nan", "div");
    raises ``CheckError`` on the first violation."""
    unknown = set(checks) - set(_CHECKS)
    if unknown:
        raise ValueError(f"unknown checks {sorted(unknown)}; known: {_CHECKS}")

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _CheckMode(checks):
            return fn(*args, **kwargs)

    return run


def nan_watch(x: torch.Tensor, name: str, mask=None) -> torch.Tensor:
    """Pass-through NaN watch: while debug mode is on, prints a warning if
    any (optionally ``mask``-selected) element of ``x`` is NaN. Returns
    ``x`` unchanged either way; costs nothing when debug mode is off."""
    if not _ENABLED:
        return x
    bad = torch.isnan(x)
    if mask is not None:
        bad = bad & mask
    n_bad = int(bad.sum())
    if n_bad > 0:
        print(f"[odt nan_watch] {name}: {n_bad} NaN element(s)", flush=True)
    return x
