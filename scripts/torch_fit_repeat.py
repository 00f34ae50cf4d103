#!/usr/bin/env python3
"""Does the port's full-width fit repeat bit for bit? Fits one clip twice
in one process and finds the first step at which the two part.

    python3 scripts/torch_fit_repeat.py [--seed 0] [--steps 300] [--device cuda]

The fit is `chip_smoke.py`'s phase 12 (its `fit_configs` and `FIT_CLIP`,
from the tree this script sits in), run twice on one clip object. A hook
that fires every step digests the state (every parameter, Adam moment,
aux tensor, density statistic and the key: each tensor's bit patterns
summed with position weights in wrapping int64), and every batch is
digested as it goes to the device. Prints each fit's alive counts at its
density events, the first step whose state differs with the tensors
that differ there, the first batch that differs, and a JSON summary as
the last line. Exits 1 if the fits part. It needs nothing of its tree but
`chip_smoke.fit_configs` / `FIT_CLIP` and `fit_clip`'s hooks, so a copy of
it also runs in an older tree, to compare a parent with its change.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402  (the fit's sizes and configs)


def digest(t) -> int:
    import torch

    b = t.detach().contiguous().view(-1)
    b = b.view(torch.int32).long() if b.dtype in (torch.float32, torch.int32) else b.long()
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64) * 2654435761 % 2147483647
    return int((b * w).sum())


def state_digests(state) -> dict:
    d = {}
    for k, v in state.scene.params.items():
        d[f"param {k}"] = digest(v)
        d[f"mu {k}"] = digest(state.opt_state.mu[k])
        d[f"nu {k}"] = digest(state.opt_state.nu[k])
    d.update({f"aux {k}": digest(v) for k, v in state.scene.aux.items()})
    d.update({f"densify {i}": digest(v) for i, v in enumerate(state.densify_state)})
    d["key"] = tuple(state.key.tolist())
    return d


def run_fit(clip, args):
    """One fit: (per-step state digests, per-batch digests, history)."""
    from splatter_a_video_tpu_torch.train import fit, hooks

    class EveryStep(hooks.Hook):
        every = 1

        def before_train(self, ctx):
            self.d = {}

        def after_train_iter(self, ctx):
            self.d[ctx.step] = state_digests(ctx.state)

    batches = []
    to_device = fit.batch_to_device

    def recorded(batch, dev):
        out = to_device(batch, dev)
        batches.append({k: digest(v) if hasattr(v, "dtype") else v for k, v in out._asdict().items()})
        return out

    fit.batch_to_device = recorded
    try:
        fcfg, tcfg = chip_smoke.fit_configs(args, args.steps)
        hook = EveryStep()
        _, hist = fit.fit_clip(clip, fcfg, tcfg, hooks=[hook], device=args.device)
    finally:
        fit.batch_to_device = to_device
    return hook.d, batches, hist


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=chip_smoke.FIT_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from splatter_a_video_tpu_torch.data import synthetic

    clip = synthetic.make_clip(synthetic.SyntheticClipConfig(seed=args.seed, **chip_smoke.FIT_CLIP))
    fits = []
    for i in range(2):
        t0 = time.perf_counter()
        steps, batches, hist = run_fit(clip, args)
        events = [(e["step"], e["num_alive"]) for e in hist[-1].get("densify_events", [])]
        print(f"fit {i}: {time.perf_counter() - t0:.1f} s, alive at the density events {events}, final "
              f"{hist[-1]['alive']}", flush=True)
        fits.append((steps, batches, hist))
    (s1, b1, h1), (s2, b2, h2) = fits
    first_batch = next((i + 1 for i, (x, y) in enumerate(zip(b1, b2)) if x != y), None)
    first_step, differ = None, []
    for step in sorted(s1):
        if s1[step] != s2.get(step):
            first_step, differ = step, sorted(k for k in s1[step] if s1[step][k] != s2[step].get(k))
            break
    print(f"first differing batch: {first_batch or 'none'}; first differing state: "
          f"{'none' if first_step is None else f'step {first_step}: ' + ', '.join(differ)}", flush=True)
    print(json.dumps({"steps": args.steps, "alive": [h1[-1]["alive"], h2[-1]["alive"]],
                      "first_differing_step": first_step, "differing": differ,
                      "first_differing_batch": first_batch}), flush=True)
    return 0 if first_step is None and first_batch is None else 1


if __name__ == "__main__":
    sys.exit(main())
