"""A cell of a second program, added from new files only: its
configuration, traffic mix, limits and entry module, beside the harness
as it stands (the entry module is put into ``sys.modules``, the files
under a temporary checkout root). The toy program's answers are not match
records: each placed object's centre in pixels, projected on the device
from the pool's ground-truth translations through the pool's camera. Its
reference and comparison are its own, and the comparison holds the
answers to the ground truth as well. On the CPU, at the small cell's
size."""

import copy
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from bench_port import run
from bench_port.tests.cells import SPEC, small_cell

BENCH = pathlib.Path(run.__file__).resolve().parent
CELL = "ycbv_small.toy_centres_b2"
LIMITS = {"frames_missing": 0, "centre_gap_px": 1e-6, "translation_gap_m": 1e-9}


class ToyEntry:
    """Each pool frame's placed objects' centres (u, v) in pixels."""

    def __init__(self, cfg, mix, bank, device, log):
        self.B = int(mix["batch"])
        self.device = torch.device(device)

    def set_pool(self, pool):
        self.t = torch.as_tensor(pool.translations, dtype=torch.float64, device=self.device)
        self.K = torch.as_tensor(pool.K, dtype=torch.float64, device=self.device)
        self.n_batches = pool.depth.shape[0] // self.B

    def calibrate(self):
        pass

    def dispatch(self, i):
        s = (i % self.n_batches) * self.B
        p = self.t[s:s + self.B] @ self.K.T
        return p[..., :2] / p[..., 2:]

    def finalize(self, handle, rows=()):
        uv = handle.cpu().numpy()
        return uv.shape[0], {r: uv[r] for r in rows}

    def summary(self):
        return f"{self.t.shape[1]} objects a frame"

    def shapes(self):
        return {}

    def reference_state(self):
        return {}

    def free(self):
        self.t = self.K = None


def reference_answers(cfg, bank, pool, sample, state, device, precision="float64"):
    """u = fx X / Z + cx, v = fy Y / Z + cy of each object, in numpy."""
    (fx, _, cx), (_, fy, cy) = pool.K[:2]
    out = {}
    for i in sample:
        X, Y, Z = np.asarray(pool.translations[i], dtype=precision).T
        out[i] = np.stack([fx * X / Z + cx, fy * Y / Z + cy], axis=-1)
    return out


def compare(got, want, pool, sample):
    """Frames not answered; the widest pixel gap to the reference; and
    the widest gap of an answer, back-projected at the ground truth's
    depth, to the ground truth's X and Y."""
    (fx, _, cx), (_, fy, cy) = pool.K[:2]
    kept = [i for i in want if i in got]
    gap = max((float(np.abs(got[i] - want[i]).max()) for i in kept), default=float("nan"))
    truth = []
    for i in kept:
        X, Y, Z = pool.translations[i].T
        truth.append(max(np.abs((got[i][:, 0] - cx) * Z / fx - X).max(),
                         np.abs((got[i][:, 1] - cy) * Z / fy - Y).max()))
    return {"frames_missing": len(want) - len(kept), "centre_gap_px": gap,
            "translation_gap_m": max(truth, default=float("nan"))}


@pytest.fixture
def toy_cell(tmp_path, monkeypatch):
    """The new files of the cell under ``tmp_path`` and the spec with the
    cell added (every per-layer metric listing it) -> (spec, root)."""
    mod = types.ModuleType("bench_port.entries.toy")
    mod.Entry, mod.reference_answers, mod.compare = ToyEntry, reference_answers, compare
    mod.load_kernels, mod.CONTROL = (lambda: None), "float32"
    monkeypatch.setitem(sys.modules, "bench_port.entries.toy", mod)
    cfg, mix, _, _, _ = small_cell()
    cfg = dict(copy.deepcopy(cfg), name="ycbv_small")
    mix = dict(copy.deepcopy(mix), name="toy_centres_b2", entry="toy")
    files = {f"bench_port/configs/{cfg['name']}.json": cfg,
             f"bench_port/traffic/{mix['name']}.json": mix,
             f"bench_port/limits/{CELL}.json": LIMITS}
    for rel, body in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(body))
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": cfg["name"], "source": "a test", "reduced": cfg["reduced"],
                            "file": f"bench_port/configs/{cfg['name']}.json", "why": "a test"})
    spec["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": mix["name"],
                              "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        m["workloads"].append(CELL)
    return spec, tmp_path


def run_toy(spec, root, trace=False, seed=11):
    _, cfg, mix, limits, e2e, per_layer = run.resolve(spec, CELL, root)
    return run.run_cell(CELL, cfg, mix, limits, e2e, per_layer, seed, 0.3, trace, "cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_cell_of_a_second_entry_is_correct(toy_cell, trace):
    out = run_toy(*toy_cell, trace=trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    assert out["checks"]["frames_missing"]["value"] == 0
    if trace:
        # no device operation on the CPU, and no program pass without program_spans
        assert out["metrics"] == {} and "busy_s" in out["device"]
    else:
        assert set(out["metrics"]) == {"frames_per_s", "setup_s"}


def test_altered_answer_is_not_correct(toy_cell, monkeypatch):
    """The toy's finalize moves the first row's first centre by half a
    pixel."""
    finalize = ToyEntry.finalize

    def altered(self, handle, rows=()):
        n, kept = finalize(self, handle, rows)
        for r in list(kept)[:1]:
            kept[r] = kept[r].copy()
            kept[r][0, 0] += 0.5
        return n, kept

    monkeypatch.setattr(ToyEntry, "finalize", altered)
    out = run_toy(*toy_cell, seed=12)
    assert not out["correct"], out["checks"]
    assert out["checks"]["centre_gap_px"]["value"] == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["run.py", "compare.py"])
def test_harness_names_no_match(name):
    """run.py and compare.py name nothing of the match (test_imports.py
    holds them to import nothing of the port)."""
    text = (BENCH / name).read_text()
    for word in ("Matcher", "compare_match", "match.program", "entries.match",
                 "records_differing"):
        assert word not in text, word
