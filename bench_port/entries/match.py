"""Entry "match": the port's match program alone on pinned frames.

The benchmark's bank (``bench_port/bank.py``) goes into the port's
``Detector`` with ``add_synthetic_template``; ``make_match_program`` is
built for it with the configuration's slots. A batch of the pool is
uploaded with ``non_blocking=True`` (the program takes tensors on the
card) and matched, and its [B, 5, K+1] record is copied back to the host.
It bypasses geometry, lift, ICP and NMS. The threshold is the
configuration's, or the one its back-off picks over the whole pool in
set-up (raised while any frame of the pool has more candidates through it
than the slots).

The reference is ``bench_port/reference/match.py``'s ``Matcher`` over the
same bank, at the threshold and the slots the program ran with; the
comparison holds each sampled frame's record to the reference's, bit for
bit. The program's spans are ``utils/profiling.py``'s ``match.*`` and
``sync.*``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from bench_port import bank as bank_mod
from object_detector_6d_tpu_torch.match import program as mp
from object_detector_6d_tpu_torch.utils import profiling

# every float step of the reference in bfloat16, the configuration's float32 less one step
CONTROL = "bfloat16"


def load_kernels() -> None:
    """Builds (in a fresh checkout) and loads the port's kernel library."""
    from object_detector_6d_tpu_torch.ops import kernels

    kernels.library()


def port_detector(cfg: dict, bank: list):
    """The port's Detector holding ``bank``, in the bank's order."""
    from object_detector_6d_tpu_torch.api.detector import Detector
    from object_detector_6d_tpu_torch.core.config import ColorGradientParams, DepthNormalParams
    from object_detector_6d_tpu_torch.quant.features import Feature, Template

    det = Detector(modalities=tuple(cfg["modalities"]), t_at_level=tuple(cfg["t_at_level"]),
                   color_gradient_params=ColorGradientParams(**cfg["color_gradient"]),
                   depth_normal_params=DepthNormalParams(**cfg["depth_normal"]))
    for tp in bank:
        det.add_synthetic_template(
            [Template(*tp["size"][lvl], lvl, [Feature(*map(int, row)) for row in f])
             for lvl in (0, 1) for f in tp["features"][lvl]], tp["class"])
    return det


class Entry:
    """The system under test for one cell (see the module docstring)."""

    def __init__(self, cfg: dict, mix: dict, bank: list, device, log):
        self.cfg, self.mix, self.log = cfg, mix, log
        self.device = torch.device(device)
        self.B = int(mix["batch"])
        self.bank = bank
        det = self.det = port_detector(cfg, bank)
        self.bargs = mp.bank_args(det.get_bank(), self.device)
        self.K_cap = int(cfg["max_hypotheses"])
        self.prog = mp.make_match_program(det.modality_names, det.t_at_level, (480, 640),
                                          det.dn_params, det.cg_params,
                                          max_candidates=self.K_cap)
        self.depth = self.bgr = None
        self._counts = {}

    def set_pool(self, pool) -> None:
        self.depth, self.bgr = pool.depth, pool.bgr
        self.n_batches = self.depth.shape[0] // self.B

    def dispatch(self, i: int):
        s = (i % self.n_batches) * self.B
        with record_function("bench.upload"):
            d = self.depth[s:s + self.B].to(self.device, non_blocking=True)
            c = self.bgr[s:s + self.B].to(self.device, non_blocking=True)
        sources = [c if name == "ColorGradient" else d for name in self.det.modality_names]
        with record_function("bench.match"):
            return self.prog(sources, *self.bargs, self.threshold)

    def finalize(self, handle, rows=()):
        """-> (frames returned, {row: that frame's [5, K+1] record})."""
        rec = handle.cpu().numpy()
        return rec.shape[0], {r: rec[r] for r in rows if r < rec.shape[0]}

    def calibrate(self) -> None:
        self.threshold = float(self.cfg["match_threshold"])
        backoff = self.cfg.get("threshold_backoff")
        while True:
            # the record's last column holds each frame's count through the threshold
            n_above = np.concatenate([self.dispatch(i).cpu().numpy()[:, 0, -1]
                                      for i in range(self.n_batches)]).astype(np.int64)
            over = int((n_above > self.K_cap).sum())
            self.log(f"threshold {self.threshold:g}: {over} of {len(n_above)} pool frames have "
                     f"more than {self.K_cap} candidates; candidates a frame min / median / "
                     f"max {n_above.min()} / {int(np.median(n_above))} / {n_above.max()}")
            if not backoff or over == 0 or self.threshold >= backoff["max"]:
                break
            self.threshold = min(self.threshold + backoff["step"], backoff["max"])
        self.pool_overflow = over
        self.pool_candidates = n_above

    def shapes(self) -> dict:
        """The cell's shapes, for the benchmark's own count of the match
        stage's work (bench_port/roofline.py), from the benchmark's bank."""
        return dict(B=self.B, H=int(self.depth.shape[1]), W=int(self.depth.shape[2]),
                    t_at_level=tuple(self.cfg["t_at_level"]),
                    modalities=tuple(self.cfg["modalities"]),
                    nfeat_l1=bank_mod.feature_counts(self.bank, 1),
                    nfeat_l0=bank_mod.feature_counts(self.bank, 0),
                    K_cap=self.K_cap,
                    live_slots=float(np.minimum(self.pool_candidates, self.K_cap).mean()))

    def summary(self) -> str:
        return (f"threshold {self.threshold:g}; {self.pool_overflow} pool frames with more "
                f"candidates than slots")

    def reference_state(self) -> dict:
        return {"threshold": self.threshold, "K_cap": self.K_cap}

    def program_spans(self, on: bool):
        """The match program's spans on or off; off -> (the spans recorded
        since they went on, the ``sync.*`` counters' increments)."""
        if on:
            profiling.take_spans()
            self._counts = dict(profiling.counts)
            profiling.enable(True)
            return None
        profiling.enable(False)
        return profiling.take_spans(), {k: v - self._counts.get(k, 0)
                                        for k, v in profiling.counts.items()}

    def free(self) -> None:
        self.prog = self.bargs = self.det = None


def reference_answers(cfg: dict, bank: list, pool, sample, state: dict, device,
                      precision: str = "float32") -> dict:
    """The plain reference's [5, K+1] record of each sampled pool frame."""
    from bench_port.reference.match import Matcher

    ref = Matcher(bank, cfg["modalities"], cfg["t_at_level"], tuple(pool.depth.shape[1:3]),
                  cfg["color_gradient"]["weak_threshold"],
                  cfg["depth_normal"]["distance_threshold"],
                  cfg["depth_normal"]["difference_threshold"], state["K_cap"], device, precision)
    idx = torch.as_tensor(sample)
    return dict(zip(sample, ref.match(pool.depth[idx], pool.bgr[idx], state["threshold"])))


def compare(got: dict, want: dict, pool, sample) -> dict:
    """Per sampled frame, the program's [5, K+1] match record against the
    reference's: records_differing counts the frames missing from ``got``
    or whose record differs in any entry (integer sums, one float32
    division and float32 angles and normals rounded once a step: equal
    inputs give equal bits)."""
    differing = 0
    for i, w in want.items():
        g = got.get(i)
        if g is None or g.shape != w.shape or not np.array_equal(g, w, equal_nan=True):
            differing += 1
    return {"records_differing": differing}
