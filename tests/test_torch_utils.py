"""The port's utils/debug.py and utils/profiling.py, with the semantics of
the reference's tests/test_utils.py: ``checked`` raises on a NaN made by
an op (log(-1)) and passes log(1); it also raises on an out-of-range
index before the op launches, and on a zero divisor; ``nan_watch``
prints only while debug mode is on; ``DeviceTimer`` returns positive
rates. The reference's JAX functions are run beside them where they
share a contract."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detector_6d_tpu.utils.debug import checked as ref_checked
from object_detector_6d_tpu.utils.profiling import DeviceTimer as RefDeviceTimer
from object_detector_6d_tpu_torch.utils import debug, profiling
from object_detector_6d_tpu_torch.utils.debug import CheckError, checked
from object_detector_6d_tpu_torch.utils.profiling import DeviceTimer, scope, trace_to

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checked_catches_nan_like_the_reference():
    def bad(x):
        return torch.log(x)  # log(-1) -> NaN

    with pytest.raises(Exception, match="nan"):
        ref_checked(lambda x: jnp.log(x), checks=("nan",))(jnp.float32(-1.0))
    with pytest.raises(CheckError, match="nan generated by log"):
        checked(bad, checks=("nan",))(torch.tensor(-1.0))
    assert float(checked(bad, checks=("nan",))(torch.tensor(1.0))) == 0.0
    # a NaN carried in from the inputs is the masked-invalid convention
    out = checked(lambda x: x + 1.0)(torch.tensor([float("nan"), 1.0]))
    assert torch.isnan(out[0]) and out[1] == 2.0


def _setitem(x, i):
    y = x.clone()
    y[i] = 0.0
    return y


# (op on a [3, 4] tensor, an index in range, an index out of range)
INDEX_CASES = {
    "getitem": (lambda x, i: x[i], [-3], [3]),
    "getitem_dim1": (lambda x, i: x[:, i], [3], [4]),
    "getitem_ellipsis": (lambda x, i: x[..., i], [-4], [-5]),
    "gather": (lambda x, i: torch.gather(x, 1, i.expand(3, -1)), [3], [4]),
    "index_select": (lambda x, i: torch.index_select(x, 0, i), [2], [3]),
    "setitem": (_setitem, [2], [3]),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_checked_catches_out_of_range_index(case):
    """Checked before the op launches: on a card an out-of-range gather is
    a device-side assert that poisons the context."""
    fn, ok, bad = INDEX_CASES[case]
    x = torch.arange(12.0).reshape(3, 4)
    run = checked(fn, checks=("index",))
    torch.testing.assert_close(run(x, torch.tensor(ok)), fn(x, torch.tensor(ok)))
    with pytest.raises(CheckError, match="out-of-bounds index"):
        run(x, torch.tensor(bad))


def test_checked_catches_zero_divisor():
    f = checked(lambda a, b: a / b, checks=("div",))
    np.testing.assert_array_equal(f(torch.ones(2), torch.tensor([2.0, 4.0])).numpy(), [0.5, 0.25])
    with pytest.raises(CheckError, match="division by zero"):
        f(torch.ones(2), torch.tensor([1.0, 0.0]))
    with pytest.raises(CheckError, match="division by zero"):
        checked(lambda a: torch.remainder(a, 0), checks=("div",))(torch.ones(2))
    with pytest.raises(ValueError, match="unknown checks"):
        checked(lambda a: a, checks=("bounds",))


def test_nan_watch_reports_only_when_enabled(capfd):
    x = torch.ones(4) * float("nan")
    debug.enable(False)
    assert debug.nan_watch(x, "t") is x
    assert "nan_watch" not in capfd.readouterr().out
    debug.enable(True)
    try:
        assert debug.debug_enabled()
        assert debug.nan_watch(x, "t") is x
        assert "[odt nan_watch] t: 4 NaN element(s)" in capfd.readouterr().out
        mask = torch.tensor([True, False, False, False])
        debug.nan_watch(x, "m", mask=mask)
        assert "m: 1 NaN element(s)" in capfd.readouterr().out
        debug.nan_watch(torch.ones(4), "clean")
        assert "nan_watch" not in capfd.readouterr().out
    finally:
        debug.enable(False)


def test_odt_debug_environment_switch():
    code = ("import torch; from object_detector_6d_tpu_torch.utils import debug; "
            "print(debug.debug_enabled()); debug.nan_watch(torch.tensor([float('nan')]), 'env')")
    for value, want in (("1", "True"), ("0", "False")):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=120, env={**os.environ, "ODT_DEBUG": value})
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines()[0] == want
        assert ("nan_watch" in out.stdout) == (value == "1")


def test_device_timer_and_scope():
    def f(x):
        with scope("test/double"):
            return x * 2

    stats = DeviceTimer(f).measure(torch.ones((32, 32)), iters=3, batch=4)
    ref = RefDeviceTimer(lambda x: x * 2).measure(jnp.ones((32, 32)), iters=3, batch=4)
    assert sorted(stats) == sorted(ref)
    assert stats["ms_per_call"] > 0 and stats["ms_per_item"] > 0
    assert stats["items_per_sec"] > 0
    # dict / tuple outputs sync through their first tensor
    assert DeviceTimer(lambda x: {"a": (x, 1)}).measure(torch.ones(3), iters=2)["ms_per_call"] > 0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    profiling.enable(True)  # the port's spans are off by default
    try:
        with trace_to(str(tmp_path / "trace")):
            with scope("test/span"):
                torch.ones(8).sum()
    finally:
        profiling.enable(False)
        profiling.take_spans()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "test/span" for e in trace["traceEvents"])
