"""A cell of BENCHMARK.json cut to a size the CPU tests can run: a bank of
one synthetic class of two templates plus the two objects, B=2, a pool of
two batches, every frame of the pool sampled."""

import copy
import json
import pathlib

from bench_port import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
MATCH = "ycbv1202.match_b128_ahead2"


def small_cell(name: str = MATCH):
    cell, cfg, mix, limits, e2e, per_layer = run.resolve(SPEC, name)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["bank"].update(n_classes=1, per_class=2)
    mix.update(batch=2, pool_batches=2, sample_frames=4, traced_batches=1)
    return cfg, mix, limits, e2e, per_layer


def run_small(name: str = MATCH, seed: int = 5, seconds: float = 0.5, trace: bool = False,
              **kw):
    cfg, mix, limits, e2e, per_layer = small_cell(name)
    return run.run_cell(name, cfg, mix, limits, e2e, per_layer, seed, seconds, trace,
                        "cpu", **kw)
