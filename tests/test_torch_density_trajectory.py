"""The port's production fit against the JAX package's through every density
event, on the CPU at a reduced production recipe (slow: about 100 minutes,
four fits of 2,000 steps side by side in a spawn pool):

  * the harness's textured synthetic clip (`scripts/e2e_480p.py`) at a
    quarter of each side: 214x120, 12 frames, `track_grid` 2, blobs of
    radius 10.5; 6,250 points (3,750 foreground, 2,500 background tracks,
    topped up from depth) in 8,192 slots (capacity factor 1.31), 256
    tracks a step, an intersection budget of 1 << 17;
  * the flagship's recipe: flow weight 2, lr horizon 8,000, density from
    step 500 every 100 (events at 600-2000) under a 5% growth budget, the
    latch at 0.97, reset every 3,000, `size_prune_always`, extent 5.0;
    2,000 steps, logged every 50.

[handoff] Before each event of JAX's fit, JAX's whole train state (params,
Adam moments, statistics, key, step) goes to numpy and into the port
(`convert.train_state_from_numpy`). From there the port takes the event
(with JAX's split noise, and once with its own draws) and the next train
step (with JAX's batch), and each is held to JAX's own:
  * the event exactly: `DensifyInfo`, the alive mask, every parameter,
    both moments, the reset statistics, the key; the split children's
    positions within 1e-6 (XLA's fused CPU code rounds their offsets
    otherwise; the port's own draws are within a few ulps of JAX's normal);
  * the step at the blend bars of `ROADMAP.md`: the training render's
    channels atol 2e-5, the gradients (from the first moments) atol 3e-4
    of each attribute's largest plus rtol 2e-3, the viewspace statistics
    at the same bars, visit counts and radii exactly, the loss terms
    rtol 1e-4.
A failure names the first event and the first field that differ. Every
step's batch of JAX's fit is also held to the port's batch stream.

[trajectory] Four fits from step 0: the port, JAX, and JAX with one
float32 ulp added to the ARAP weight (the perturbation that moved JAX's
mini-fit, `PERF.md` §5) or to the rgb weight (every step's image gradient
moves by about the port's own rounding). At each log step: training PSNR,
depth loss, alive and true intersections; each event's counts. The report
prints the step up to which the port is as close to JAX as JAX is to
itself (its PSNR distance from JAX within the running spread of the
perturbed JAX fits, plus 0.05 dB, until one of them parts from JAX by more
than 0.5 dB) and whether each fit turns (PSNR at 2000 more than 3 dB below
its value at 1500); the test holds the fits' integrity only.

Run: `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_density_trajectory.py -m slow -s -q`.
"""

import concurrent.futures as cf
import multiprocessing as mp
import os
from types import SimpleNamespace

import numpy as np
import pytest

pytestmark = pytest.mark.slow

STEPS, LOG = 2000, 50
W, H, FRAMES, GRID, BLOB = 214, 120, 12, 2, 10.5
FG, BG, INIT_N, CAPF, NTRACK, MAXI = 3750, 2500, 6250, 1.31, 256, 1 << 17
CAP = 8192          # ceil(6250 * 1.31 / 128) * 128
# one float32 ulp up from the defaults: the ARAP weight (1e-3, a small term) and
# the rgb weight (10, every step's image gradient: about the port's own rounding)
ARAP_ULP = float(np.nextafter(np.float32(1e-3), np.float32(np.inf)))
RGB_ULP = float(np.nextafter(np.float32(10.0), np.float32(np.inf)))
YARDSTICKS = ("jax_arap_ulp", "jax_rgb_ulp")
POS_ATOL, IMG_ATOL, G_ATOL, G_RTOL, LOSS_RTOL = 1e-6, 2e-5, 3e-4, 2e-3, 1e-4
PART_DB, SPREAD_DB, TURN_DB = 0.5, 0.05, 3.0


def packages(which):
    """The modules one package's fit needs."""
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from splatter_a_video_tpu.data import synthetic
        from splatter_a_video_tpu.train import density, fit, optim, trainer
    else:
        from splatter_a_video_tpu_torch.data import synthetic
        from splatter_a_video_tpu_torch.train import density, fit, optim, trainer
    return SimpleNamespace(synthetic=synthetic, density=density, fit=fit, optim=optim, trainer=trainer)


def make_clip(p):
    return p.synthetic.make_clip(p.synthetic.SyntheticClipConfig(
        width=W, height=H, num_frames=FRAMES, blob_radius=BLOB, num_blobs=6, track_grid=GRID, texture=True))


def configs(p, steps, **weights):
    """(FitConfig, TrainerConfig) of the reduced recipe in package `p`."""
    fcfg = p.fit.FitConfig(num_iters=steps, num_fg_samples=FG, num_bg_samples=BG, num_track_samples=NTRACK,
                           log_every=LOG, capacity_factor=CAPF, init_num_points=INIT_N)
    dcfg = p.density.DensifyConfig(densify_start_iter=500, densify_stop_iter=100000, prune_interval=100,
                                   duplicate_interval=100, opacity_reset_interval=3000,
                                   densify_grad_threshold=0.0002, max_growth_frac=0.05, size_prune_always=True,
                                   cameras_extent=5.0, saturation_stop=0.97)
    tcfg = p.trainer.TrainerConfig(width=W, height=H, num_frames=FRAMES, nearest=0.2, loss_flow_weight=2.0,
                                   num_track_samples=NTRACK, max_intersections=MAXI,
                                   optim=p.optim.OptimConfig(max_steps=8000), densify=dcfg, **weights)
    return fcfg, tcfg


def log_rows(hist):
    return [(m["step"], float(m["psnr"]), float(m["loss_depth"]), int(m["alive"]), int(m["num_intersections"]))
            for m in hist]


# ---- the hand-off, inside the JAX fit's process -----------------------------


def _first(bad):
    return next((k for k, v in bad.items() if v), None)


class Handoff:
    """The port's event and next step on JAX's state before each event."""

    def __init__(self, steps, jcfg, extr, frames):
        import jax
        import jax.numpy as jnp
        import torch
        from splatter_a_video_tpu.train import trainer as jtr

        tp = packages("port")
        self.torch = torch
        self.extr = np.asarray(extr, np.float32)
        _, self.cfg = configs(tp, steps)
        rcfg, extr_j = jcfg.raster_cfg(), jnp.asarray(self.extr)
        self.jrender = jax.jit(lambda inp, pos2: jtr._render_with_sinks(
            inp, extr_j, rcfg, {"track_gs": pos2}, jcfg.white_bg, jnp.zeros((pos2.shape[0], 2)),
            jnp.zeros((pos2.shape[0], 2)), depth_bg=jcfg.depth_bg).features)
        tframes = tp.trainer.FrameStore(*(None if f is None else torch.from_numpy(np.array(f)) for f in frames))
        self.train, self.density, _ = tp.trainer.make_train_step(self.cfg, extr, frames=tframes, device="cpu")
        self.tp = tp

    def event(self, pre, post, info):
        """Hold the port's event on JAX's pre-event state to JAX's event."""
        import jax
        from splatter_a_video_tpu_torch import convert
        from test_torch_train_step import jax_state_arrays

        torch = self.torch
        arrays = jax_state_arrays(pre)
        cap = arrays["aux"]["alive"].shape[0]
        _, sub = jax.random.split(pre.key)
        noise = torch.from_numpy(np.array(jax.random.normal(sub, (cap, 3))))
        ts = convert.train_state_from_numpy(**arrays, device="cpu")
        tpost, tinfo = self.density(ts, noise=noise)
        own, own_info = self.density(convert.train_state_from_numpy(**arrays, device="cpu"))
        j = jax_state_arrays(post)
        t = convert.train_state_to_numpy(tpost)
        kids = ~arrays["aux"]["alive"] & j["aux"]["alive"]
        jinfo = [int(x) for x in info]
        rec = {"step": int(pre.step), "info": jinfo, "bad": {}}
        bad = rec["bad"]
        bad["info"] = [int(x) for x in tinfo] != jinfo
        bad["alive"] = not np.array_equal(t["aux"]["alive"], j["aux"]["alive"])
        for k, v in j["params"].items():
            if k == "position":
                bad[k] = not np.array_equal(t["params"][k][~kids], v[~kids]) or \
                    bool(np.abs(t["params"][k][kids] - v[kids]).max(initial=0) > POS_ATOL)
            else:
                bad[k] = not np.array_equal(t["params"][k], v)
        for kind in ("mu", "nu"):
            for k, v in j["opt"][kind].items():
                bad[f"{kind}[{k}]"] = not np.array_equal(t["opt"][kind][k], v)
        for k, v in j["densify"].items():
            bad[f"densify[{k}]"] = bool(np.any(t["densify"][k])) or bool(np.any(v))
        bad["key"] = not np.array_equal(t["key"], j["key"])
        rec["children_pos_max_abs"] = float(np.abs(t["params"]["position"][kids]
                                                   - j["params"]["position"][kids]).max(initial=0))
        own_pos = own.scene.params["position"].numpy()
        rec["own_draws"] = {
            "info_equal": [int(x) for x in own_info] == jinfo,
            "alive_equal": bool(np.array_equal(own.scene.alive.numpy(), j["aux"]["alive"])),
            "pos_max_abs": float(np.abs(own_pos - j["params"]["position"]).max()),
        }
        rec["first_bad"] = _first(bad)
        return rec, tpost

    def step(self, pending, jstate, jbatch, jnext, jmetrics):
        """Hold the port's next step (from its own post-event state) to JAX's."""
        from splatter_a_video_tpu_torch import convert
        from test_torch_train_step import jax_state_arrays

        torch = self.torch
        rec, tpost = pending
        tb = self.tp.trainer.Batch(int(jbatch.t1), int(jbatch.t2), *(
            None if a is None else torch.from_numpy(np.array(a)) for a in jbatch[2:]))
        tnext, tm = self.train(tpost, tb)
        j0, j1 = jax_state_arrays(jstate), jax_state_arrays(jnext)
        t0, t1 = convert.train_state_to_numpy(tpost), convert.train_state_to_numpy(tnext)
        out = {"bad": {}, "loss_rel": {}, "grad_ratio": {}}
        bad = out["bad"]
        for k in jmetrics:
            jv, tv = float(jmetrics[k]), float(tm[k])
            out["loss_rel"][k] = abs(tv - jv) / max(abs(jv), 1e-12)
            bad[f"metric[{k}]"] = out["loss_rel"][k] > LOSS_RTOL
        out["image_max_abs"] = self.image_diff(jstate, tpost, jbatch)
        for name, d in out["image_max_abs"].items():
            bad[f"image[{name}]"] = d > IMG_ATOL
        b1 = self.cfg.optim.b1
        for k in j1["opt"]["mu"]:
            gj = (j1["opt"]["mu"][k].astype(np.float64) - b1 * j0["opt"]["mu"][k]) / (1 - b1)
            gt = (t1["opt"]["mu"][k].astype(np.float64) - b1 * t0["opt"]["mu"][k]) / (1 - b1)
            out["grad_ratio"][k] = bar_ratio(gt, gj)
            bad[f"grad[{k}]"] = out["grad_ratio"][k] > 1.0
        out["grad_ratio"]["viewspace"] = bar_ratio(t1["densify"]["pos_grad_accum"], j1["densify"]["pos_grad_accum"])
        bad["densify[pos_grad_accum]"] = out["grad_ratio"]["viewspace"] > 1.0
        for k in ("denom", "max_radii2d"):
            bad[f"densify[{k}]"] = not np.array_equal(t1["densify"][k], j1["densify"][k])
        out["first_bad"] = _first(bad)
        rec["train_step"] = out
        return rec

    def image_diff(self, jstate, tpost, jbatch):
        """Max |port - JAX| of each channel group of the training render of
        the post-event scene at the batch's frame pair."""
        from splatter_a_video_tpu.train import trainer as jtr

        torch = self.torch
        tr = self.tp.trainer
        t1, t2 = int(jbatch.t1), int(jbatch.t2)
        js = jstate.scene
        jout = self.jrender(jtr.scene_render_inputs(js, t1), js.get_position(t2))
        ts = tpost.scene
        tinp = tr.scene_render_inputs(ts, t1)
        tsink = torch.zeros((ts.alive.shape[0], 2))
        with torch.no_grad():
            tout = tr._render_with_sinks(tinp, torch.from_numpy(self.extr),
                                         self.cfg.raster_cfg(), {"track_gs": ts.get_position(t2)},
                                         self.cfg.white_bg, tsink, tsink, depth_bg=self.cfg.depth_bg)
        return {k: float(np.abs(tout.features[k].numpy() - np.array(v)).max()) for k, v in jout.items()}


def bar_ratio(t, j):
    """max |t - j| / (G_ATOL * max|j| + G_RTOL * |j|): at most 1 within the bars."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = np.abs(j).max()
    if scale == 0:
        return float(np.abs(t).max() > 0) * 2.0
    return float((np.abs(t - j) / (G_ATOL * scale + G_RTOL * np.abs(j))).max())


def run_fit(which, steps=STEPS, handoff=False, **weights):
    """One fit of the reduced recipe: its log rows, each event's (step,
    cloned, split, pruned, dropped, alive) and, for JAX with `handoff`,
    each event's hand-off record and the first step (if any) whose batch
    differs from the port's batch stream."""
    import torch

    torch.set_num_threads(1)
    p = packages(which)
    fcfg, tcfg = configs(p, steps, **weights)
    clip = make_clip(p)
    events, handoffs = [], []
    if which == "port":
        _, hist = p.fit.fit_clip(clip, fcfg, tcfg, device="cpu")
        events = [(e["step"], e["num_cloned"], e["num_split"], e["num_pruned"], e["dropped"], e["num_alive"])
                  for e in hist[-1]["densify_events"]]
        return {"log": log_rows(hist), "events": events, "handoffs": handoffs}
    port_batches = batch_differs = None
    if handoff:
        from splatter_a_video_tpu_torch.data import pairs as tpairs

        tclip = make_clip(packages("port"))
        port_batches = tpairs.batch_stream(
            tpairs.PairSampler(tpairs.PairSamplerConfig(num_frames=tclip.num_frames, seed=fcfg.seed)),
            tpairs.BatchBuilder(tclip, fcfg.num_track_samples, seed=fcfg.seed, slim=True), steps)

    make = p.trainer.make_train_step

    def make_observed(cfg, extr, frames=None):
        train, density, reset = make(cfg, extr, frames=frames)
        ho = None
        if handoff:
            ho = Handoff(steps, cfg, extr, frames)
        pending = []

        def train_step(state, batch):
            nonlocal batch_differs
            if port_batches is not None and batch_differs is None:
                tb = next(port_batches)
                if not all(same_array(a, b) for a, b in zip(batch, tb)):
                    batch_differs = int(state.step) + 1
            new, metrics = train(state, batch)
            if pending:
                handoffs.append(ho.step(pending.pop(), state, batch, new, metrics))
            return new, metrics

        def density_step(state):
            new, info = density(state)
            events.append((int(state.step), *(int(x) for x in info)))
            if ho is not None:
                rec = ho.event(state, new, info)
                if int(state.step) < steps:
                    pending.append(rec)
                else:
                    handoffs.append(rec[0])
            return new, info

        return train_step, density_step, reset

    p.trainer.make_train_step = make_observed   # this worker's own module
    _, hist = p.fit.fit_clip(clip, fcfg, tcfg)
    return {"log": log_rows(hist), "events": events, "handoffs": handoffs, "batch_differs": batch_differs}


def same_array(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def run_all(steps=STEPS):
    """The four fits side by side, each in a process of its own."""
    jobs = {"jax": dict(which="jax", steps=steps, handoff=True),
            "jax_arap_ulp": dict(which="jax", steps=steps, arap_weight=ARAP_ULP),
            "jax_rgb_ulp": dict(which="jax", steps=steps, loss_rgb_weight=RGB_ULP),
            "port": dict(which="port", steps=steps)}
    env = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with cf.ProcessPoolExecutor(len(jobs), mp_context=mp.get_context("spawn")) as pool:
            futs = {k: pool.submit(run_fit, **kw) for k, kw in jobs.items()}
            return {k: f.result() for k, f in futs.items()}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---- the verdicts ---------------------------------------------------------------


def turn(log):
    """(turns, PSNR at 1500, PSNR at 2000) of a fit's log."""
    psnr = {s: p for s, p, *_ in log}
    a, b = psnr.get(1500), psnr.get(2000)
    return (a is not None and b is not None and b < a - TURN_DB), a, b


def parting(ref, other, db=PART_DB):
    """The first log step where two fits' PSNR differ by more than `db`."""
    return next((s for (s, a, *_), (_, b, *_) in zip(ref, other) if abs(a - b) > db), None)


def closeness(runs):
    """(the first log step where a perturbed JAX fit parts from JAX, the
    port's own parting step, the last log step up to which the port's PSNR
    distance from JAX stays within the perturbed fits' running spread plus
    SPREAD_DB)."""
    j, t = runs["jax"]["log"], runs["port"]["log"]
    parts = [parting(j, runs[y]["log"]) for y in YARDSTICKS]
    part = min((x for x in parts if x is not None), default=None)
    spread, ok_until = 0.0, None
    for i, (s, pj, *_) in enumerate(j):
        if part is not None and s >= part:
            break
        spread = max([spread] + [abs(runs[y]["log"][i][1] - pj) for y in YARDSTICKS])
        if abs(t[i][1] - pj) > spread + SPREAD_DB:
            break
        ok_until = s
    return part, parting(j, t), ok_until


FITS = ("port", "jax") + YARDSTICKS


def report(runs):
    print("\nstep | PSNR " + " / ".join(FITS) + " | depth loss (same order) | alive (same order)")
    for rows in zip(*(runs[k]["log"] for k in FITS)):
        print(f"{rows[0][0]} | " + " / ".join(f"{r[1]:.4f}" for r in rows) + " | "
              + " / ".join(f"{r[2]:.5f}" for r in rows) + " | " + " / ".join(str(r[3]) for r in rows))
    for k in FITS:
        print(f"{k} events (step, cloned, split, pruned, dropped, alive):", runs[k]["events"])
        print(f"{k} turns, PSNR 1500, PSNR 2000:", turn(runs[k]["log"]),
              "peak intersections:", max(r[4] for r in runs[k]["log"]))
    part, port_part, ok = closeness(runs)
    print("a perturbed JAX fit parts from JAX (> 0.5 dB) at:", part, "; the port parts at:", port_part,
          "; the port within the JAX fits' spread up to:", ok)
    print("first step whose batch differs from the port's batch stream:", runs["jax"]["batch_differs"])
    for rec in runs["jax"]["handoffs"]:
        st = rec.get("train_step", {})
        print("handoff", rec["step"], rec["info"], "event:", rec["first_bad"], "children pos",
              rec["children_pos_max_abs"], "own draws", rec["own_draws"], "| step:", st.get("first_bad"),
              "image", st.get("image_max_abs"), "grad/bar", max(st.get("grad_ratio", {0: 0}).values()),
              "loss rel", max(st.get("loss_rel", {0: 0}).values()))


@pytest.fixture(scope="module")
def runs():
    out = run_all()
    report(out)
    return out


def test_handoff_events_are_exact(runs):
    recs = runs["jax"]["handoffs"]
    assert [r["step"] for r in recs] == [e[0] for e in runs["jax"]["events"]] and recs
    bad = [(r["step"], r["first_bad"]) for r in recs if r["first_bad"]]
    assert not bad, f"first event and field that differ: {bad[0]}"
    for r in recs:
        assert r["own_draws"]["info_equal"] and r["own_draws"]["alive_equal"], r["step"]
        assert r["own_draws"]["pos_max_abs"] <= POS_ATOL, r["step"]


def test_handoff_steps_within_blend_bars(runs):
    recs = [r for r in runs["jax"]["handoffs"] if "train_step" in r]
    assert [r["step"] for r in recs] == [e[0] for e in runs["jax"]["events"] if e[0] < STEPS] and recs
    bad = [(r["step"], r["train_step"]["first_bad"]) for r in recs if r["train_step"]["first_bad"]]
    assert not bad, f"first event and field whose next step differs: {bad[0]}"


def test_batches_are_the_ports(runs):
    """Every step's batch (frame pair, track rows) of JAX's fit equals the
    port's batch stream's."""
    assert runs["jax"]["batch_differs"] is None


def test_fits_trajectories(runs):
    """Each fit logs every 50 steps, finite, its density events run from
    step 600 every 100 until the latch, and the intersection budget never
    binds. How close the port stays to JAX, against the perturbed JAX fits,
    is measured and printed (`report`), not held to a bound: it is the
    quantity this file exists to read."""
    for k in FITS:
        log = runs[k]["log"]
        assert [r[0] for r in log] == list(range(LOG, STEPS + 1, LOG)), k
        assert all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in log), k
        steps = [e[0] for e in runs[k]["events"]]
        assert steps == list(range(600, 600 + 100 * len(steps), 100)) and steps, k
        latched = runs[k]["events"][-1][5] >= 0.97 * CAP
        assert steps[-1] == STEPS or latched, k
        assert max(r[4] for r in log) < MAXI, k        # the budget never binds
