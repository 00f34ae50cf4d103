"""Float32 operations BootsTAPIR's inference needs (`reference/tapir.py`),
from the model's widths and the clip's shape: a multiply-add is 2, a
bilinear sample 8 a channel (4 weights applied, 3 adds, a multiply). What
is counted: every convolution and linear, the cost volume, the samplers and
the correlations. What is not: norms, activations, softmax and soft argmax,
pads and copies (a few percent at most), so the count is a lower bound.

`grid_ops` is the work of one video's feature grids, which the result needs
once per video whatever the number of queries; `query_ops` the work of one
query through the cost volume, its head and the PIPs iterations.
"""

from __future__ import annotations

from typing import Tuple

SAMPLE = 8              # operations of a bilinear sample, a channel
WINDOW = 49             # the 7x7 neighbourhood


def conv(k: int, cin: int, cout: int, h: int, w: int) -> int:
    """A k x k convolution from cin to cout channels onto an h x w output."""
    return 2 * k * k * cin * cout * h * w


def linear(cin: int, cout: int) -> int:
    return 2 * cin * cout


def depthwise(k: int, cout: int) -> int:
    """A depthwise temporal convolution, one input channel per output, a position."""
    return 2 * k * cout


def _down(n: int, s: int) -> int:
    return -(-n // s)


def grid_sizes(m: dict) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(h, w) of the high-res and the low-res grid."""
    h, w = m["initial_resolution"]
    h, w = _down(h, 2), _down(w, 2)
    sizes = []
    for s in m["strides"]:
        h, w = _down(h, s), _down(w, s)
        sizes.append((h, w))
    return sizes[1], sizes[-1]


def grid_ops(m: dict, frames: int) -> int:
    """The feature grids of `frames` frames: the trunk and the ExtraConvs."""
    ih, iw = m["initial_resolution"]
    h, w = _down(ih, 2), _down(iw, 2)
    ch = m["channels_per_group"]
    ops = conv(7, 3, ch[0], h, w)
    cin = ch[0]
    for n, cout, s in zip(m["blocks_per_group"], ch, m["strides"]):
        for b in range(n):
            if b == 0:
                h, w = _down(h, s), _down(w, s)
                ops += conv(1, cin, cout, h, w) + conv(3, cin, cout, h, w)
            else:
                ops += conv(3, cout, cout, h, w)
            ops += conv(3, cout, cout, h, w)
        cin = cout
    C = m["lowres_dim"]
    ops += m["extra_convs"] * (conv(3, C, 4 * C, h, w) + conv(3, 4 * C, C, h, w))
    return ops * frames


def query_ops(m: dict, frames: int) -> int:
    """One query tracked through `frames` frames, its grids given."""
    (hh, hw), (lh, lw) = grid_sizes(m)
    C_hi, C_lo, H = m["highres_dim"], m["lowres_dim"], m["mixer_hidden_dim"]
    # the cost volume and its head, a frame
    init = (2 * C_lo * lh * lw + conv(3, 1, 16, lh, lw) + conv(3, 16, 1, lh, lw)
            + conv(3, 16, 32, _down(lh, 2), _down(lw, 2)) + linear(32, 16) + linear(16, 2))
    # an iteration, a frame: the neighbourhoods and their correlations at each level, the mixer
    levels = [C_hi, C_lo] + [C_lo] * m["pyramid_level"]
    sample = sum(WINDOW * (SAMPLE + 2) * c for c in levels)
    mix_out = 4 + C_hi + C_lo
    mix_in = mix_out + len(levels) * WINDOW
    block = depthwise(3, 4 * H) * 2 + 4 * H + linear(H, 4 * H) + linear(4 * H, H)
    mix = linear(mix_in, H) + m["num_mixer_blocks"] * block + linear(H, mix_out)
    return frames * (init + m["num_pips_iter"] * (sample + mix))
