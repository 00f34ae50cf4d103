"""The ranks of the port's data-parallel and depth-slab tests: spawned by
`torch.multiprocessing`, they meet in a gloo group through a `FileStore`,
run the jobs they are given and save what each rank computed. They import
only the port (the JAX side runs in the test process)."""

import os

import torch

TIMEOUT_S = 240


def run(jobs, out_dir, world=2, timeout_s=TIMEOUT_S):
    """Run `jobs` on `world` spawned gloo ranks; returns each rank's results."""
    import torch.multiprocessing as mp

    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_rank_main, args=(world, store, out_dir, jobs), nprocs=world, join=False,
                             start_method="spawn")
    try:
        import time

        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True) for r in range(world)]


def _rank_main(rank, world, store, out_dir, jobs):
    torch.set_num_threads(1)
    from splatter_a_video_tpu_torch.parallel import mesh

    mesh.init_process_group("gloo", store_path=store, rank=rank, world_size=world, timeout_s=TIMEOUT_S)
    try:
        out = {name: JOBS[job["kind"]](job) for name, job in jobs.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _state_out(st):
    return {"params": dict(st.scene.params), "mu": dict(st.opt_state.mu), "nu": dict(st.opt_state.nu),
            "densify": st.densify_state._asdict(), "key": st.key, "step": torch.tensor(st.step)}


def _metrics(m):
    return {k: v.detach().reshape(()).float() for k, v in m.items()}


def _train(job):
    from splatter_a_video_tpu_torch import convert
    from splatter_a_video_tpu_torch.parallel import dp

    st = convert.train_state_from_numpy(**job["state"], device="cpu")
    step = dp.make_dp_train_step(job["cfg"], job["extr"], device="cpu")
    st, m = step(st, job["batch"])
    return {"state": _state_out(st), "metrics": _metrics(m)}


def _atlas(job):
    from splatter_a_video_tpu_torch import convert
    from splatter_a_video_tpu_torch.parallel import dp

    st = convert.atlas_train_state_from_numpy(**job["state"], device="cpu")
    step = dp.make_dp_atlas_step(job["cfg"], job["extr"], device="cpu")
    st, m = step(st, job["batch"])
    out = {n: {"params": dict(s.params), "mu": dict(st.opt_states[n].mu), "nu": dict(st.opt_states[n].nu),
               "densify": st.densify_states[n]._asdict()} for n, s in st.model.atlases.items()}
    return {"atlases": out, "key": st.key, "metrics": _metrics(m)}


def _joint(job):
    from splatter_a_video_tpu_torch import convert
    from splatter_a_video_tpu_torch.parallel import dp
    from splatter_a_video_tpu_torch.train import camera_refine

    base = convert.train_state_from_numpy(**job["state"], device="cpu")
    xi, opt = convert.cam_state_from_numpy(**job["cam"], device="cpu")
    step = dp.make_dp_joint_step(job["cfg"], job["extr"], device="cpu", **job["kw"])
    cs, m = step(camera_refine.CamTrainState(base, xi, opt), job["batch"])
    return {"state": _state_out(cs.base), "xi": cs.cam_xi, "cam_mu": cs.cam_opt_state.mu["xi"],
            "metrics": _metrics(m)}


def _shard(job):
    from splatter_a_video_tpu_torch.parallel import render_shard

    args = [torch.from_numpy(job[k]) for k in ("position", "scaling", "rotation", "opacity", "shs")]
    return render_shard.render_gaussians_sharded(*args, job["extr"], job["cfg"])


def _fit(job):
    from splatter_a_video_tpu_torch.data import synthetic
    from splatter_a_video_tpu_torch.train import fit, hooks

    clip = synthetic.make_clip(synthetic.SyntheticClipConfig())
    st, hist = fit.fit_clip(clip, job["fcfg"], job["tcfg"], hooks=[hooks.CheckPointHook(every=job["every"])],
                            out_dir=job["out_dir"], device="cpu")
    return {"state": _state_out(st), "loss": torch.tensor([m["loss"] for m in hist])}


JOBS = {"train": _train, "atlas": _atlas, "joint": _joint, "shard": _shard, "fit": _fit}
