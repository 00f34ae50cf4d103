"""The readings that the limits of `limits/<configuration>.json` are set from.

    python3 port_bench/control.py --workload fit_2160p --seeds 11 12 13 --seconds 3 --init-seeds 14 15

runs the cell once per seed of `--seeds` in one process, as `run.py` does
(the program's readings against the reference: the sound run), and then puts
in the program's place, against the same reference:

  * `control`: the reference's steps computed with TF32 on (matmuls and
    cuDNN convolutions), the precision below the configuration's float32
    with TF32 off;
  * `half`: the reference's steps with the top half of each frame's image
    losses only (half of the batch left out, the mean taken over the rest);
  * `drop_depth_grad`: the reference's steps with the depth channel's image
    gradient dropped where it is made (an answer altered);
  * `init_control`: the program's own scene set-up (`scene_from_tracks`,
    whose kNN scale initialisation is a matmul) on its lifted tracks, with
    TF32 on;
  * `init_nearest_depth`: the reference's initial scene with every depth
    sampled at the nearest pixel (an answer altered where it is made).

Each goes through `compare.verdict` with the committed limits, and its line
says whether it came out correct. (A state left unchanged reads 1 on
`grad_gap` and `change_gap` by their definition and needs no run.) For each
seed of `--init-seeds` it makes only the clip, the program's initial scene
(`lift_clip`, `scene_from_tracks`) and the reference's, and reads the
`init_*` numbers. One JSON line per seed on standard output. The benchmark's
own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _judged(nums: dict, lim: dict) -> dict:
    from port_bench import compare

    return {"numbers": nums, "correct": all(c["ok"] for c in compare.verdict(nums, lim))}


def _program_init(scene) -> dict:
    return {"params": {k: v.detach().cpu() for k, v in scene.params.items()}, "alive": scene.aux["alive"].cpu(),
            "knots": scene.aux["spline_knots"].cpu() if "spline_knots" in scene.aux else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--init-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    import torch

    from port_bench import clip as _clip
    from port_bench import compare, harness, manifest
    from port_bench.reference import follow, scene
    from splatter_a_video_tpu_torch.train import fit

    man = manifest.load_manifest()
    wl = manifest.cell(man, args.workload)
    cfg, tr, lim = manifest.config(wl["config"]), manifest.traffic(wl["traffic"]), manifest.limits(wl["config"])
    dev = torch.device("cuda")
    steps = tr["check_steps"]
    lift = fit.lift_clip
    lifted = {}

    def kept_lift(*a, **k):
        lifted["out"] = lift(*a, **k)
        return lifted["out"]

    for seed in args.seeds:
        fit.lift_clip = kept_lift
        try:
            out = harness.run_cell(cfg, tr, lim, seed, args.seconds, False, dev, time.perf_counter(), {}, [],
                                   keep=True)
        finally:
            fit.lift_clip = lift
        kept = out.pop("kept")
        fs = harness.fit_seed(seed)
        rec = {"seed": seed, "fit_ms_per_step": out["fit_ms_per_step"], "setup_s": out["setup_s"],
               "reference_s": out["phases"]["reference_s"],
               "sound": {c["name"]: c["value"] for c in out["check"]}, "correct": all(c["ok"] for c in out["check"])}
        t0 = time.perf_counter()
        _tf32(True)
        try:
            ctl = follow.follow(kept["init"], kept["clip"], cfg, fs, steps, dev)
            ctl_ev = follow.event(kept["event_pre"], cfg, dev) if kept["event_pre"] is not None else None
        finally:
            _tf32(False)
        nums = compare.step_numbers(ctl, kept["ref"])
        if ctl_ev is not None:
            nums.update(compare.event_numbers({**ctl_ev, "moments_left": 0}, kept["event_ref"], dev))
        rec["control"] = _judged(nums, lim)
        rec["control_s"] = time.perf_counter() - t0
        for name, kw in (("half", {"half": True}), ("drop_depth_grad", {"drop_depth_grad": True})):
            f = follow.follow(kept["init"], kept["clip"], cfg, fs, steps, dev, **kw)
            rec[name] = _judged(compare.step_numbers(f, kept["ref"]), lim)
        track_seq, colors = lifted.pop("out")
        fcfg, _ = harness.program_configs(cfg, seed)
        _tf32(True)
        try:
            sc, _ = fit.scene_from_tracks(track_seq, colors, cfg["num_frames"], fcfg, device=dev)
        finally:
            _tf32(False)
        rec["init_control"] = _judged(compare.init_numbers(_program_init(sc), kept["ref_init"]), lim)
        del sc, track_seq, colors
        near = scene.initial_scene(kept["clip"], cfg, fs, dev, nearest=True)
        rec["init_nearest_depth"] = _judged(compare.init_numbers(near, kept["ref_init"]), lim)
        print(json.dumps(rec), flush=True)
        del kept, out, near
        gc.collect()
        torch.cuda.empty_cache()

    for seed in args.init_seeds:
        t0 = time.perf_counter()
        clip = _clip.make_clip(_clip.spec_from_config(cfg), seed, dev)
        fcfg, _ = harness.program_configs(cfg, seed)
        track_seq, colors = fit.lift_clip(_clip.to_video_flow(clip), fcfg)
        sc, _ = fit.scene_from_tracks(track_seq, colors, cfg["num_frames"], fcfg, device=dev)
        prog = _program_init(sc)
        del sc, track_seq, colors
        t1 = time.perf_counter()
        ref = scene.initial_scene(clip, cfg, harness.fit_seed(seed), dev)
        rec = {"seed": seed, "program_s": t1 - t0, "reference_init_s": time.perf_counter() - t1,
               "sound": compare.init_numbers(prog, ref)}
        print(json.dumps(rec), flush=True)
        del clip, prog, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
