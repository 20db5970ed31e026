"""Time K1 (cg_quantize), K2 (dn_quantize), K3 (response_spread) and K4
(refine_sweep) against another version of their sources, in turns, on one
CUDA card.

    python3 kernel_ab.py OLD_CSRC_DIR

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
both levels, 4 launches; K4: 2). Each version's output must equal the
plain twin's.
Then each kernel is timed old, new, new, old (CUDA events, mean ms per
batch over REPS batches after a warm-up; K4 also with the 50 MB L2
flushed before each batch). The last line is one JSON object with every
time and the card's nvidia-smi name and power limit.
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
    args = ap.parse_args()
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

    # K1: both pyramid levels of the batch
    weak2 = float(np.float32(pd.detector.cg_params.weak_threshold) ** 2)
    x0 = torch.as_tensor(rgbs, device=dev)
    levels = [x0, pyr_down_u8(x0)]
    outs = [torch.empty(x.shape[:3], dtype=torch.uint8, device=dev) for x in levels]

    def k1(lib):
        def run():
            for x, o in zip(levels, outs):
                kernels.check(lib.odc_cg_quantize(x.data_ptr(), o.data_ptr(), *x.shape[:3],
                                                  weak2, stream), "cg_quantize")
        return run

    # K2: the batch's depth frames; the two-pass design's entry point also
    # takes a u8 scratch plane (told from its source)
    dn = pd.detector.dn_params
    d0 = torch.as_tensor(depths.astype(np.int32), device=dev)
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

    # K4: the match program's two launches
    calls = cs.capture_refine_args(dev, pd, depths, rgbs, K)

    def k4(lib):
        return cs.refine_launcher(lib, calls, dev)[0]

    # K3: the match program's four launches
    k3_calls = cs.capture_response_args(dev, pd, depths, rgbs, K)

    def k3(lib):
        return cs.response_launcher(lib, k3_calls, dev)[0]

    for lib, tag in ((old, "old"), (new, "new")):
        k1(lib)()
        for x, o in zip(levels, outs):
            cs.compare(f"{tag} cg_quantize {tuple(x.shape)}", o,
                       quantize.cg_quantize_plain(x, pd.detector.cg_params.weak_threshold))
        k2_out.fill_(255)
        k2(lib)()
        cs.compare(f"{tag} dn_quantize {tuple(d0.shape)}", k2_out,
                   quantize.dn_quantize_plain(d0, int(dn.distance_threshold),
                                              int(dn.difference_threshold)))
        run, k3_outs = cs.response_launcher(lib, k3_calls, dev)
        run()
        for (q, t), out in zip(k3_calls, k3_outs):
            cs.compare(f"{tag} response_spread T={t} {tuple(q.shape)}", out,
                       response.response_spread_plain(q, t))
        run, k4_outs = cs.refine_launcher(lib, calls, dev)
        run()
        for a, out in zip(calls, k4_outs):
            cs.compare(f"{tag} refine_sweep {tuple(a[0].shape)}", out,
                       refine.refine_sweep_plain(*a))
    cs.log(f"old and new K1, K2, K3, K4 equal their twins on the main path's inputs; {gpu}")

    res = {"gpu": gpu, "reps": REPS}
    for name, make, timer in (("cg_quantize", k1, cs.cuda_ms),
                              ("dn_quantize", k2, cs.cuda_ms),
                              ("response_spread", k3, cs.cuda_ms),
                              ("refine_sweep", k4, cs.cuda_ms),
                              ("refine_sweep_cold", k4, cs.cuda_ms_cold)):
        turns = [("old", old), ("new", new), ("new", new), ("old", old)]
        times = [(tag, timer(make(lib), reps=REPS)) for tag, lib in turns]
        res[name] = {"turns": times,
                     "old_ms": (times[0][1] + times[3][1]) / 2,
                     "new_ms": (times[1][1] + times[2][1]) / 2}
        cs.log(f"{name}: " + ", ".join(f"{t} {ms:.4f}" for t, ms in times) + f" ms per batch; {gpu}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
