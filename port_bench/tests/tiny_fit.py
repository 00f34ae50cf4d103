"""The fit entry's CPU case: a fit configuration cut to a size the CPU runs
in seconds, every kind of layer kept, and its traffic."""

import copy
import math

from port_bench import manifest

TRAFFIC = {"warm_steps": 3, "check_steps": 2, "trace_skip": 0, "trace_steps": 2}


def config(name: str = "flagship_2160p") -> dict:
    cfg = copy.deepcopy(manifest.config(name))
    alive = 600
    cfg.update(frame_size=[64, 36], num_frames=6, num_blobs=2, blob_radius=6.0, track_grid=4,
               alive_at_start=alive, capacity_factor=1.25, num_fg_samples=300, num_bg_samples=200,
               max_intersections=1 << 14, num_iters=1000)
    cfg["capacity"] = math.ceil(alive * 1.25 / 128) * 128
    cfg["recipe"]["fit"]["num_track_samples"] = 128
    cfg["recipe"]["loss"]["arap_sample_num"] = 32
    cfg["recipe"]["density"].update(prune_interval=2, duplicate_interval=2)
    return cfg
