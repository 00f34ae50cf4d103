"""The logged metrics of a production-harness fit, one line per log step:
step, training PSNR, depth loss, the training render's true intersection
count and the alive count, then the eval record's quality, for each
intersection budget given. The fit is `scripts/torch_e2e_480p.py`'s, read
from the same `E480_*` knobs; nothing is written.

    E480_TEXTURE=1 E480_GROWTH_FRAC=0.05 E480_LR_STEPS=8000 E480_STEPS=2000 \\
        python3 scripts/torch_fit_log.py --maxi 1048576 2097152

A fit repeats bit for bit on the card, and its first N steps do not depend
on E480_STEPS (only the log cadence, E480_STEPS // 40, does), so a short
run shows the steps of a long one. A budget the training render never
reaches leaves the fit unchanged.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_e2e_480p as e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxi", type=int, nargs="+", default=[1 << 20], help="intersection budgets, one fit each")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for maxi in args.maxi:
        s = e2e.read_env({**os.environ, "E480_MAXI": str(maxi)})
        rec, _, hist, _ = e2e.run(s, device=args.device, write=False)
        print(f"budget {s.maxi}: step, psnr, loss_depth, num_intersections, alive:",
              [(m["step"], round(m["psnr"], 2), round(m["loss_depth"], 3), int(m["num_intersections"]), m["alive"])
               for m in hist], flush=True)
        print(f"budget {s.maxi}: record", json.dumps({
            "recon_psnr": rec["recon"]["psnr"], "ssim": rec["recon"]["ssim"],
            "aj": rec["tapvid"]["average_jaccard"], "oa": rec["tapvid"]["occlusion_accuracy"],
            **{k: rec[k] for k in ("final_alive", "densify_totals", "eval_num_intersections", "hardware")}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
