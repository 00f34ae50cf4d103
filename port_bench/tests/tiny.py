"""A cell's configuration cut to a size the CPU runs in seconds."""

import copy
import math

from port_bench import manifest

TINY_TRAFFIC = {"warm_steps": 3, "check_steps": 2, "trace_skip": 0, "trace_steps": 2}


def tiny_config(name: str = "flagship_2160p") -> dict:
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

TINY_TRACKS_TRAFFIC = {"queries_per_call": 16, "warm_calls": 1, "check_queries": 24, "trace_skip": 0,
                       "trace_calls": 1}


def tiny_tracks_config(name: str = "bootstapir_480p") -> dict:
    """4 frames of 48x32 at 64x64, a model of the same layers at widths of
    8 to 32, 2 mixer blocks and 1 ExtraConv."""
    cfg = copy.deepcopy(manifest.config(name))
    cfg["model"].update(initial_resolution=[64, 64], highres_dim=16, lowres_dim=32, channels_per_group=[8, 16, 32, 32],
                        mixer_hidden_dim=32, num_mixer_blocks=2, extra_convs=1)
    cfg["clip"].update(frame_size=[48, 32], num_frames=4, num_blobs=2, blob_radius=6.0)
    cfg["query_chunk"] = 8
    return cfg
