"""Time the six hand kernels, K1 (cg_quantize), K2 (dn_quantize), K3
(response_spread), K4 (refine_sweep), K5 (fused_scene) and K6
(coarse_sweep), against another version of their sources, in turns, on one
CUDA card.

    python3 kernel_ab.py OLD_CSRC_DIR [--kernels K5,K6]

OLD_CSRC_DIR is another version's ``object_detector_6d_tpu_torch/csrc``,
for example a parent commit's, unpacked with ``git archive`` into a
git-ignored directory such as ``build/``. Both versions are built with the
same nvcc flags (ops/kernels.py) and called through the same C entry
points, on the inputs of chip_smoke.py's two-modality main path: K1 on the
B=32 480x640 BGR frames and on their pyr_down_u8 level (both launches of a
batch), K2 on the B=32 480x640 int32 depth frames (a version whose entry
point still takes the two-pass design's u8 scratch plane is given one),
K3 and K4 on their launches' own arguments, captured from one call
of the match program (K3: the ColorGradient and DepthNormal images at
both levels, 4 launches; K4: 2), K5 on the B=32 480x640 int32 depth
frames with the detect program's own FusedScene tables, K6 on the main
path's stacked level-1 planes D [32,1024,30,40] and the bank's coarse
tables. Each version's output must equal the plain twin's (K5's with
NaN == NaN). Then each kernel is timed old, new, new, old (CUDA events,
mean ms per batch over REPS batches after a warm-up; K4, K5 and K6 also
with the 50 MB L2 flushed before each batch). ``--kernels`` keeps the run
to the named kernels; ``--timing-only-old`` skips the old version's
equality check. The last line is one JSON object with every time
and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
REPS = 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old_csrc", type=pathlib.Path)
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5,K6",
                    help="comma-separated subset of K1..K6 (default: all)")
    ap.add_argument("--timing-only-old", action="store_true",
                    help="do not hold OLD_CSRC_DIR's kernels against the twins (a variant "
                         "that is built only to see what a step costs)")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    if not want or want - {"K1", "K2", "K3", "K4", "K5", "K6"}:
        ap.error(f"--kernels {args.kernels}: a comma-separated subset of K1..K6")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from object_detector_6d_tpu_torch.ops import kernels, quantize, refine, response
    from object_detector_6d_tpu_torch.quant.pyramid import pyr_down_u8

    gpu = cs.gpu_line()
    dev = torch.device("cuda:0")
    new = kernels.library()
    old_so, old_log = kernels.build(args.old_csrc.resolve(),
                                    kernels.BUILD_ROOT.parent / "kernel_ab")
    old = kernels.load(old_so)
    for tag, text in (("old", old_log), ("new", kernels.build_info["log"])):
        for line in text.splitlines():  # empty when the library was built before
            if "entry function" in line or "registers" in line:
                cs.log(f"ptxas {tag}: {line.strip()}")
    stream = kernels.stream_ptr(dev)

    scenes = cs.scenes_module()
    K = scenes.K_DEFAULT
    pd = cs.train(cs.two_modality_bank(), dev, scenes, K)
    depths, rgbs, _ = cs.make_frames(scenes, K, cs.B, seed=cs.SEED2)

    det = pd.detector
    d0 = torch.as_tensor(depths.astype(np.int32), device=dev)
    # name -> (a function lib -> launcher, a function (lib, tag) that holds
    # the version's output against the twin, the timers)
    cases = {}
    warm, cold = ("", cs.cuda_ms), ("_cold", cs.cuda_ms_cold)

    if "K1" in want:  # both pyramid levels of the batch
        weak = det.cg_params.weak_threshold
        weak2 = float(np.float32(weak) ** 2)
        x0 = torch.as_tensor(rgbs, device=dev)
        levels = [x0, pyr_down_u8(x0)]
        outs = [torch.empty(x.shape[:3], dtype=torch.uint8, device=dev) for x in levels]

        def k1(lib):
            def run():
                for x, o in zip(levels, outs):
                    kernels.check(lib.odc_cg_quantize(x.data_ptr(), o.data_ptr(), *x.shape[:3],
                                                      weak2, stream), "cg_quantize")
            return run

        def k1_check(lib, tag):
            k1(lib)()
            for x, o in zip(levels, outs):
                cs.compare(f"{tag} cg_quantize {tuple(x.shape)}", o,
                           quantize.cg_quantize_plain(x, weak))

        cases["cg_quantize"] = (k1, k1_check, (warm,))

    if "K2" in want:
        # the two-pass design's entry point also takes a u8 scratch plane
        # (told from its source)
        dn = det.dn_params
        k2_out = torch.empty(d0.shape, dtype=torch.uint8, device=dev)
        k2_scratch = torch.empty_like(k2_out)
        old_two_pass = "void* scratch" in (args.old_csrc / "dn_quantize.cu").read_text()
        tail = (*d0.shape, int(dn.distance_threshold), int(dn.difference_threshold), stream)
        if old_two_pass:
            sig = old.odc_dn_quantize.argtypes
            old.odc_dn_quantize.argtypes = [sig[0], *sig]

        def k2(lib):
            ptrs = ((d0.data_ptr(), k2_scratch.data_ptr(), k2_out.data_ptr())
                    if lib is old and old_two_pass else (d0.data_ptr(), k2_out.data_ptr()))

            def run():
                kernels.check(lib.odc_dn_quantize(*ptrs, *tail), "dn_quantize")
            return run

        def k2_check(lib, tag):
            k2_out.fill_(255)
            k2(lib)()
            cs.compare(f"{tag} dn_quantize {tuple(d0.shape)}", k2_out,
                       quantize.dn_quantize_plain(d0, int(dn.distance_threshold),
                                                  int(dn.difference_threshold)))

        cases["dn_quantize"] = (k2, k2_check, (warm,))

    if "K3" in want:  # the match program's four launches
        k3_calls = cs.capture_response_args(dev, pd, depths, rgbs, K)

        def k3_check(lib, tag):
            run, k3_outs = cs.response_launcher(lib, k3_calls, dev)
            run()
            for (q, t), out in zip(k3_calls, k3_outs):
                cs.compare(f"{tag} response_spread T={t} {tuple(q.shape)}", out,
                           response.response_spread_plain(q, t))

        cases["response_spread"] = (
            lambda lib: cs.response_launcher(lib, k3_calls, dev)[0], k3_check, (warm,))

    if "K4" in want:  # the match program's two launches
        k4_calls = cs.capture_refine_args(dev, pd, depths, rgbs, K)

        def k4_check(lib, tag):
            run, k4_outs = cs.refine_launcher(lib, k4_calls, dev)
            run()
            for a, out in zip(k4_calls, k4_outs):
                cs.compare(f"{tag} refine_sweep {tuple(a[0].shape)}", out,
                           refine.refine_sweep_plain(*a))

        cases["refine_sweep"] = (
            lambda lib: cs.refine_launcher(lib, k4_calls, dev)[0], k4_check, (warm, cold))

    if "K5" in want:  # the detect program's own FusedScene on the batch's depth
        fs = pd.program(*depths.shape[1:], K)[0].fused_scene
        k5_out = torch.empty((d0.shape[0], 8, *d0.shape[1:]), dtype=torch.float32, device=dev)

        def k5(lib):
            def run():
                kernels.check(lib.odc_fused_scene(
                    d0.data_ptr(), fs.rays.data_ptr(), fs.minv.data_ptr(), k5_out.data_ptr(),
                    *d0.shape, fs.rfx, fs.rfy, stream), "fused_scene")
            return run

        def k5_check(lib, tag):
            k5_out.fill_(-1.0)
            k5(lib)()
            cs.compare_planes(f"{tag} fused_scene {tuple(d0.shape)}", k5_out, fs.plain(d0))

        cases["fused_scene"] = (k5, k5_check, (warm, cold))

    if "K6" in want:  # the main path's stacked level-1 planes and the bank's tables
        D, tables, gh, gw = cs.coarse_main_inputs(dev, pd, rgbs, depths)
        k6_args = [D.contiguous()] + [t.to(torch.int32).contiguous() for t in tables]
        k6_out = torch.empty((D.shape[0], tables[0].shape[0], gh, gw), dtype=torch.int32,
                             device=dev)

        def k6(lib):
            def run():
                kernels.check(lib.odc_coarse_sweep(
                    *(a.data_ptr() for a in k6_args), k6_out.data_ptr(), *D.shape,
                    *tables[0].shape, gh, gw, stream), "coarse_sweep")
            return run

        def k6_check(lib, tag):
            k6_out.fill_(-1)
            k6(lib)()
            cs.compare(f"{tag} coarse_sweep {tuple(D.shape)}", k6_out,
                       refine.coarse_sweep_plain(D, *tables, gh, gw))

        cases["coarse_sweep"] = (k6, k6_check, (warm, cold))

    checked = ((new, "new"),) if args.timing_only_old else ((old, "old"), (new, "new"))
    for lib, tag in checked:
        for _, check, _ in cases.values():
            check(lib, tag)
    cs.log(f"{' and '.join(tag for _, tag in checked)} {', '.join(cases)} equal their twins "
           f"on the main path's inputs; {gpu}")

    res = {"gpu": gpu, "reps": REPS}
    for name, (make, _, timers) in cases.items():
        for suffix, timer in timers:
            turns = [("old", old), ("new", new), ("new", new), ("old", old)]
            times = [(tag, timer(make(lib), reps=REPS)) for tag, lib in turns]
            res[name + suffix] = {"turns": times,
                                  "old_ms": (times[0][1] + times[3][1]) / 2,
                                  "new_ms": (times[1][1] + times[2][1]) / 2}
            cs.log(f"{name}{suffix}: " + ", ".join(f"{t} {ms:.4f}" for t, ms in times)
                   + f" ms per batch; {gpu}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
