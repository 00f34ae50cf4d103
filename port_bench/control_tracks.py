"""The readings that `limits/<configuration>.json` of a tracks cell is set from.

    python3 port_bench/control_tracks.py --workload tracks_480p --seeds 11 12 13 --seconds 3

runs the cell once per seed in one process, as `run.py` does (the program's
answers against the reference's: the sound run), and then puts in the
program's place, against the same reference on the same video, weights and
queries:

  * `control`: the reference computed with TF32 on (matmuls and cuDNN
    convolutions), the precision below the configuration's float32;
  * `one_iter_fewer`: the reference with one PIPs iteration fewer (a step
    that returns its state unchanged);
  * `no_extra_convs`: the reference with the ExtraConvs skipped (a layer
    left out where the low-res grid is made);
  * `bf16_grids`: the reference with both feature grids rounded to
    bfloat16 (an answer altered where it is made);
  * `half_batch`: the reference's answers with the second half of each
    chunk's queries given the first half's (half of the batch left out).

Each goes through the entry's `verdict` with the committed limits, and its
line says whether it came out correct, beside the quantiles of each gap
(`readings`). One JSON line per seed on standard output. The benchmark's
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


def _half(ans: dict, chunk: int) -> dict:
    out = {}
    for k, v in ans.items():
        v = v.clone()
        for s in range(0, v.shape[0], chunk):
            n = min(chunk, v.shape[0] - s) // 2
            v[s + n:s + 2 * n] = v[s:s + n]
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import manifest
    from port_bench.reference import tapir as ref

    man = manifest.load_manifest()
    wl = manifest.cell(man, args.workload)
    cfg, tr, lim = manifest.config(wl["config"]), manifest.traffic(wl["traffic"]), manifest.limits(wl["config"])
    ent = manifest.entry(manifest.entry_name(cfg))
    m = cfg["model"]
    faults = {"one_iter_fewer": {"pips_iters": m["num_pips_iter"] - 1}, "no_extra_convs": {"skip_extra": True},
              "bf16_grids": {"dtype": torch.bfloat16}}
    dev = torch.device("cuda")
    for seed in args.seeds:
        out = ent.run(cfg, tr, lim, seed, args.seconds, False, dev, time.perf_counter(), {}, keep=True)
        kept = out.pop("kept")
        rec = {"seed": seed, "preprocess_ms_per_frame": out["metrics"]["preprocess_ms_per_frame"],
               "setup_s": out["metrics"]["setup_s"], "reference_s": out["phases"]["reference_s"],
               "sound": {c["name"]: c["value"] for c in out["check"]}, "correct": all(c["ok"] for c in out["check"]),
               "sound_readings": ent.readings(cfg, kept["prog"], kept["ref"])}
        runs = {"control": {}, **faults, "half_batch": None}
        for name, kw in runs.items():
            t0 = time.perf_counter()
            tf32 = name == "control"
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                got = None if kw is None else ref.run(m, kept["params"], kept["video"], kept["queries"], block=cfg["query_chunk"], **kw)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            if name == "half_batch":
                got = _half(kept["ref"], cfg["query_chunk"])
            nums = ent.numbers(cfg, got, kept["ref"])
            rec[name] = {"numbers": nums, "correct": all(c["ok"] for c in ent.verdict(nums, lim)),
                         "readings": ent.readings(cfg, got, kept["ref"]), "s": time.perf_counter() - t0}
            del got
        print(json.dumps(rec), flush=True)
        del kept, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
