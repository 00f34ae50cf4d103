"""The tracks entry's CPU case: the tracking configuration cut to a size the
CPU runs in seconds, every kind of layer kept, and its traffic."""

import copy

from port_bench import manifest

TRAFFIC = {"queries_per_call": 16, "warm_calls": 1, "check_queries": 24, "trace_skip": 0, "trace_calls": 1}


def config(name: str = "bootstapir_480p") -> dict:
    """4 frames of 48x32 at 64x64, a model of the same layers at widths of
    8 to 32, 2 mixer blocks and 1 ExtraConv."""
    cfg = copy.deepcopy(manifest.config(name))
    cfg["model"].update(initial_resolution=[64, 64], highres_dim=16, lowres_dim=32, channels_per_group=[8, 16, 32, 32],
                        mixer_hidden_dim=32, num_mixer_blocks=2, extra_convs=1)
    cfg["clip"].update(frame_size=[48, 32], num_frames=4, num_blobs=2, blob_radius=6.0)
    cfg["query_chunk"] = 8
    return cfg
