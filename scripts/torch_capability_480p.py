"""Flagship-scale capabilities of one fitted 480p scene, through the
PyTorch/CUDA port: tracking, an appearance edit, an NVS orbit, stereo, 2x
interpolation and the layer split. The port's counterpart of
`scripts/capability_480p.py`: the same sections, seeds, step counts and
report.

    python3 scripts/torch_capability_480p.py

reads `out/e480_torch/final_scene.npz` (written by
`scripts/torch_e2e_480p.py`; a scene saved by `scripts/e2e_480p.py` loads
too, the npz is plain numpy) and writes

  out/e480_torch/capability/
    capability_480p.json, tracks_pred.npy   always
    tracking_f*.png, edit_*.png, nvs_*, stereo_t*.png, interp_2x.*,
    layers_{fg,bg}.png                      when imageio imports
  CAPABILITY_480p_torch.json                (not in QUICK mode)

Env: CAP_QUICK=1 shrinks everything for a plumbing run; CAP_CPU=1 runs the
plain PyTorch path on the CPU (else the GPU, no fallback); CAP_SCENE=<npz>
targets another saved scene; CAP_ONLY=layers[,edit,...] runs only the
named sections and merges their entries into the existing report.
"""

import json
import os
import sys
import time
from typing import Mapping, Optional

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np

from splatter_a_video_tpu_torch import convert, inference
from splatter_a_video_tpu_torch.data import synthetic
from splatter_a_video_tpu_torch.device import hardware, resolve_device
from splatter_a_video_tpu_torch.eval import metrics
from splatter_a_video_tpu_torch.models import camera, gaussians, trajectory
from splatter_a_video_tpu_torch.ops import rasterize
from splatter_a_video_tpu_torch.train import fit
from splatter_a_video_tpu_torch.utils import vis

OUTDIR = os.path.join(ROOT, "out", "e480_torch", "capability")
SCENE = os.path.join(ROOT, "out", "e480_torch", "final_scene.npz")
REPORT = os.path.join(ROOT, "CAPABILITY_480p_torch.json")
# the flagship's sizes and step counts, and CAP_QUICK's
FULL = dict(width=854, height=480, frames=48, blob_radius=42.0, maxi=1 << 20, queries=48, edit_steps=500,
            nvs_views=16, interp_div=2)
QUICK = dict(width=214, height=120, frames=8, blob_radius=10.0, maxi=1 << 15, queries=16, edit_steps=100,
             nvs_views=6, interp_div=4)


def load_scene(path: str, num_frames: int = 48, device="cuda") -> gaussians.GaussianScene:
    """A scene saved with `scripts/e2e_480p.py`'s npz keys (every param,
    `alive`, `spline_knots`): a cubic spline over `num_frames` frames with
    the mask and DINO render attributes; the knots are rebuilt and their
    interval count checked against the saved coefficients."""
    npz = np.load(path)
    scfg = gaussians.SceneConfig(
        capacity=npz["position"].shape[0], num_frames=num_frames, traj="cubic_spline",
        render_attributes=(("mask_attribute", 1), ("dino_attribute", 3)),
    )
    knots = trajectory.spline_knots(num_frames, scfg.frames_per_knot)
    n_knot_iv = npz["pos_cubic_coeff"].shape[2]
    if len(knots) != n_knot_iv + 1:
        raise ValueError(f"{path}: {n_knot_iv} spline intervals, but {num_frames} frames give {len(knots) - 1}")
    params = {k: npz[k] for k in npz.files if k not in ("alive", "spline_knots")}
    aux = {"alive": npz["alive"], "spline_knots": knots.astype(npz["spline_knots"].dtype)}
    return convert.scene_from_numpy(params, aux, scfg, device=device)


class Outputs:
    """The capability directory; images and videos only when imageio
    imports (the GPU machine may lack it)."""

    def __init__(self, outdir: str):
        self.dir = outdir
        os.makedirs(outdir, exist_ok=True)
        try:
            import imageio.v2  # noqa: F401
            self.images = True
        except ImportError:
            self.images = False
        print(f"images and videos: {'written' if self.images else 'not written (imageio does not import)'}; "
              "the report and tracks_pred.npy: written", flush=True)

    def png(self, name: str, img) -> None:
        if self.images:
            import imageio.v2 as imageio

            imageio.imwrite(os.path.join(self.dir, name), np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8))

    def video(self, name: str, frames, fps: int) -> None:
        if self.images:
            vis.write_video(os.path.join(self.dir, name), frames, fps=fps)


def _rgb(out) -> np.ndarray:
    return np.clip(out.features["rgb"].cpu().numpy(), 0, 1)


def run(quick: bool = False, device="cuda", scene_path: Optional[str] = None, only=(),
        outdir: str = OUTDIR, report_path: Optional[str] = REPORT, sizes: Optional[dict] = None) -> dict:
    """The six sections of `scripts/capability_480p.py:132-262` on the
    scene at `scene_path` (QUICK: a scene built from a small clip, not
    fitted), at `sizes` (default FULL, or QUICK). Writes the report to
    `outdir` and, unless QUICK, to `report_path`; returns it."""
    t_all = time.time()
    dev = resolve_device(device)
    p = sizes or (QUICK if quick else FULL)
    W, H, T, MAXI = p["width"], p["height"], p["frames"], p["maxi"]
    only = set(only)
    section = lambda name: not only or name in only
    io = Outputs(outdir)
    # the textured clip the scene was fitted on (the frames depend only on
    # the geometry; track_grid only thins the GT queries)
    clip = synthetic.make_clip(synthetic.SyntheticClipConfig(
        width=W, height=H, num_frames=T, blob_radius=p["blob_radius"], num_blobs=6, track_grid=8, texture=True))
    if quick:
        scene, _ = fit.build_scene_from_clip(
            clip, fit.FitConfig(num_fg_samples=300, num_bg_samples=200, init_num_points=600), device=dev)
    else:
        scene = load_scene(scene_path or SCENE, T, device=dev)

    cam = camera.canonical_camera(W, H)
    rcfg = rasterize.RasterizeConfig(width=W, height=H, max_intersections=MAXI)
    extr = cam.extrinsic
    key_frames = [0, T // 4, T // 2, 3 * T // 4, T - 1]
    mask0 = np.asarray(clip.get_mask(0)) > 0     # frame-0 fg (tracking and edit)
    report = {"date": time.strftime("%Y-%m-%d"), "quick": quick,
              "scale": {"width": W, "height": H, "frames": T, "capacity": int(scene.cfg.capacity),
                        "alive": int(scene.num_alive)},
              "timings_s": {}}
    prev = os.path.join(outdir, "capability_480p.json")
    if only and os.path.exists(prev):   # partial re-run: merge into the existing report
        with open(prev) as f:
            merged = json.load(f)
        merged.update({k: v for k, v in report.items() if k != "timings_s"})
        merged.setdefault("timings_s", {})
        report = merged
    print(f"scene loaded: {int(scene.num_alive)} alive / {scene.cfg.capacity}", flush=True)

    # sanity: the render must reproduce the fitted clip
    t0 = time.time()
    psnr0 = metrics.psnr(_rgb(inference.render_frame(scene, 0.0, extr, rcfg, device=dev)), clip.frames[0])
    report["recon_psnr_f0"] = round(psnr0, 2)
    report["timings_s"]["first_render"] = round(time.time() - t0, 1)
    print(f"frame-0 recon PSNR {psnr0:.2f}", flush=True)

    if section("tracking"):
        # queries on the frame-0 fg mask, trajectories from the scene's own
        # track_gs channel
        t0 = time.time()
        ys, xs = np.nonzero(mask0)
        rng = np.random.RandomState(0)
        NQ = p["queries"]
        sel = rng.choice(len(ys), min(NQ, len(ys)), replace=False)
        px0 = np.stack([xs[sel], ys[sel]], axis=1).astype(np.float32)
        tracks = np.zeros((len(px0), T, 2), np.float32)
        occl = np.zeros((len(px0), T), bool)
        for t2 in range(T):
            px2, occ = inference.track_correspondences(scene, 0.0, px0, float(t2), cam, rcfg, device=dev)
            tracks[:, t2] = px2
            occl[:, t2] = occ
        for kf in key_frames:
            io.png(f"tracking_f{kf:02d}.png", vis.draw_tracks_2d(clip.frames[kf], tracks[:, : kf + 1], radius=2,
                                                                 tail=12))
        np.save(os.path.join(outdir, "tracks_pred.npy"), tracks)
        report["timings_s"]["tracking"] = round(time.time() - t0, 1)
        report["tracking"] = {"num_queries": int(len(px0)), "mean_occluded_frac": round(float(occl.mean()), 4)}
        print(f"tracking overlays done ({time.time() - t0:.0f}s)", flush=True)

    if section("edit"):
        # recolour the fg region of frame 0 (channel rotation), select the
        # contributing Gaussians under the mask, re-optimise their SH, and
        # show the edit propagating to later frames
        t0 = time.time()
        target = clip.frames[0].copy()
        target[mask0] = target[mask0][:, [2, 0, 1]]          # rgb -> brg inside fg
        io.png("edit_target.png", target)
        sel_ids = inference.select_gaussians_by_mask(scene, mask0, cam, rcfg, t=0.0, K_idx=10, device=dev)
        edited = inference.optimize_appearance(scene, sel_ids, target, cam, rcfg, t=0.0,
                                               steps=p["edit_steps"], device=dev)
        edit_frames = {}
        for t in key_frames:
            edit_frames[t] = _rgb(inference.render_frame(edited, float(t), extr, rcfg, device=dev))
            io.png(f"edit_t{t}.png", edit_frames[t])
        # edit-region PSNR at t=0 against the target; outside-region PSNR
        # against the untouched frame (the edit must stay local)
        m3 = mask0[..., None]
        edit_psnr = metrics.psnr(edit_frames[0] * m3, target * m3)
        keep_psnr = metrics.psnr(edit_frames[0] * (1 - m3), clip.frames[0] * (1 - m3))
        report["edit"] = {"num_selected": int(len(sel_ids)), "edit_region_psnr_t0": round(edit_psnr, 2),
                          "outside_region_psnr_t0": round(keep_psnr, 2)}
        report["timings_s"]["edit"] = round(time.time() - t0, 1)
        print(f"edit: {len(sel_ids)} gaussians, region PSNR {edit_psnr:.2f}, "
              f"outside {keep_psnr:.2f} ({time.time() - t0:.0f}s)", flush=True)

    if section("nvs"):
        t0 = time.time()
        NV = p["nvs_views"]
        nvs = inference.render_nvs(scene, cam, rcfg, times=np.linspace(0, T - 1, NV), radius=0.15, device=dev)
        io.video("nvs_orbit.mp4", nvs, fps=8)
        for i in (0, NV // 2):
            io.png(f"nvs_v{i:02d}.png", nvs[i])
        report["timings_s"]["nvs"] = round(time.time() - t0, 1)
        print(f"nvs orbit done ({time.time() - t0:.0f}s)", flush=True)

    if section("stereo"):
        t0 = time.time()
        stereo = inference.render_stereo(scene, cam, rcfg, times=[0.0, float(T // 2)], device=dev)
        io.png("stereo_t0.png", stereo[0])
        io.png(f"stereo_t{T // 2}.png", stereo[1])
        report["timings_s"]["stereo"] = round(time.time() - t0, 1)
        print(f"stereo done ({time.time() - t0:.0f}s)", flush=True)

    if section("interp"):
        # fractional times are free (continuous trajectories); temporal
        # coherence = how far f(t+.5) lands from the mean of its neighbours,
        # over the neighbours' difference (a linear blend would score 0)
        t0 = time.time()
        NI = T // p["interp_div"]
        times = np.arange(0, NI, 0.5, dtype=np.float32)
        res = inference.render_video(scene, cam, rcfg, list(times), device=dev)
        io.video("interp_2x.mp4", res["rgb"], fps=16)
        mids, ends = res["rgb"][1::2], res["rgb"][0::2]
        tc = []
        for i in range(len(mids) - (0 if len(ends) > len(mids) else 1)):
            a, b, m = ends[i], ends[i + 1], mids[i]
            tc.append(float(np.abs(m - 0.5 * (a + b)).mean() / (np.abs(b - a).mean() + 1e-6)))
        report["interp"] = {"frames_rendered": int(len(times)), "tc_mid_vs_blend": round(float(np.mean(tc)), 4)}
        report["timings_s"]["interp"] = round(time.time() - t0, 1)
        print(f"interpolation done, tc={np.mean(tc):.4f} ({time.time() - t0:.0f}s)", flush=True)

    if section("layers"):
        t0 = time.time()
        fg_s, bg_s = inference.split_layers(scene)
        for name, s in (("fg", fg_s), ("bg", bg_s)):
            io.png(f"layers_{name}.png", _rgb(inference.render_frame(s, 0.0, extr, rcfg, device=dev)))
        report["layers"] = {"fg_alive": int(fg_s.num_alive), "bg_alive": int(bg_s.num_alive)}
        report["timings_s"]["layers"] = round(time.time() - t0, 1)

    report["timings_s"]["total"] = round(time.time() - t_all, 1)
    report["hardware"] = hardware(dev)
    with open(os.path.join(outdir, "capability_480p.json"), "w") as f:
        json.dump(report, f, indent=2)
    if not quick and report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {os.path.abspath(report_path)}", flush=True)
    return report


def read_env(env: Optional[Mapping[str, str]] = None) -> dict:
    """run()'s arguments from CAP_QUICK, CAP_CPU, CAP_SCENE and CAP_ONLY."""
    env = os.environ if env is None else env
    return dict(quick=env.get("CAP_QUICK", "0") == "1",
                device="cpu" if env.get("CAP_CPU", "0") == "1" else "cuda",
                scene_path=env.get("CAP_SCENE", SCENE),
                only=tuple(filter(None, env.get("CAP_ONLY", "").split(","))))


def main() -> int:
    print(json.dumps(run(**read_env())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
