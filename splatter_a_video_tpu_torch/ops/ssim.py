"""SSIM / D-SSIM (counterpart of `splatter_a_video_tpu/ops/ssim.py`).

11x11 Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2, C2 = 0.03^2,
channel-last images. On the CPU (`ssim_plain`) the separable window is
applied as two banded-matrix products (B_H @ img @ B_W^T), the JAX
package's form, so both packages sum the same terms there. On the card
`ssim` runs the fused kernel pair of `csrc/ssim.cu`: the same window,
padding, constants and map, with each blurred value summed over its 11
taps in order, so the card's values differ from the band products' in the
last bits.

Precision is load-bearing: SSIM's variance terms blur(x^2) - mu^2 cancel
O(1) values down to O(1e-3), and reduced-precision products (bf16 on the
TPU, TF32 on Hopper) turn its gradient into noise (the JAX package
measured training PSNR 30 -> 18 before pinning full precision). The port
turns TF32 off at import (`splatter_a_video_tpu_torch/__init__.py`), and
the kernels are float32 throughout; keep both so.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils import spans as _spans
from . import _build

WINDOW = 11
SIGMA = 1.5
C1 = 0.01**2
C2 = 0.03**2

# launches of each kernel since the counts were last set to 0
LAUNCHES = {"ssim_forward": 0, "ssim_backward": 0}

_ARGTYPES = {
    "ssim_forward": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 3,
    "ssim_backward": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 3,
    "ssim_block_count": [ctypes.c_int] * 4,
    "ssim_attributes": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _window(window_size: int, sigma: float) -> np.ndarray:
    """The normalised 1-D Gaussian, float32."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """[n, n] banded blur matrix on `device` (built once: at 854x480 the two
    matrices are 3.8 MB, too much to copy to the card at every call): row i
    holds the 1-D Gaussian centred at i, truncated at the borders (a
    zero-padded same convolution)."""
    g = _window(window_size, sigma)
    b = np.zeros((n, n), np.float32)
    half = window_size // 2
    for off, w in zip(range(-half, half + 1), g):
        if abs(off) < n:   # an image narrower than the window keeps the taps that fit
            b += np.diag(np.full(n - abs(off), w, np.float32), k=off)
    return torch.from_numpy(b).to(device)


def _blur(img: torch.Tensor, window_size: int, sigma: float = SIGMA) -> torch.Tensor:
    """[N, H, W, C] separable same-padded Gaussian blur via two matmuls."""
    _, H, W, _ = img.shape
    bh = _band_matrix(H, window_size, sigma, img.device)
    bw = _band_matrix(W, window_size, sigma, img.device)
    out = torch.einsum("hH,nHwc->nhwc", bh, img)
    return torch.einsum("wW,nhWc->nhwc", bw, out)


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = WINDOW,
               size_average: bool = True) -> torch.Tensor:
    """Plain version of `ssim`, by band products on any device: what the CPU
    runs, and what the kernels are held to on the card."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1 = _blur(img1, window_size)
    mu2 = _blur(img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


# --------------------------------------------------------------------------
# the kernel pair (csrc/ssim.cu)
# --------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _taps():
    """The 13 floats the kernels take: the window, C1 and C2 in float32."""
    return (ctypes.c_float * (WINDOW + 2))(*_window(WINDOW, SIGMA).tolist(), float(np.float32(C1)),
                                       float(np.float32(C2)))


def _kernel(symbol: str):
    fn = getattr(_build.load("ssim"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_longlong if symbol == "ssim_block_count" else ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    _spans.count("ssim_kernel")


def kernel_attributes(backward: bool = False, need_x: bool = True, need_y: bool = False, C: int = 3) -> dict:
    """Registers per thread, local (spill) bytes per thread and shared bytes
    per block (static and a launch's dynamic at C channels) of the forward
    or backward instance for the inputs that need a gradient
    (`cudaFuncGetAttributes`)."""
    out = (ctypes.c_int * 3)()
    rc = _kernel("ssim_attributes")(int(backward), int(need_x), int(need_y), C, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"ssim_attributes failed with CUDA error {rc}")
    return {"regs": out[0], "local_bytes": out[1], "shared_bytes": out[2]}


def ssim_forward(x: torch.Tensor, y: torch.Tensor, size_average: bool, need_x: bool, need_y: bool):
    """The forward kernel on contiguous float32 [N, H, W, C] x and y: (the
    mean, or [N] per-image means; the map's partial derivatives
    [2 + need_x + need_y, N, H, W, C], or None if neither needs a gradient)."""
    N, H, W, C = x.shape
    dev = x.device
    sums = torch.empty((int(_kernel("ssim_block_count")(N, H, W, C)),), dtype=torch.float32, device=dev)
    planes = (torch.empty((2 + need_x + need_y, N, H, W, C), dtype=torch.float32, device=dev)
              if need_x or need_y else None)
    _launch("ssim_forward", x.data_ptr(), y.data_ptr(), N, H, W, C, ctypes.addressof(_taps()),
            int(need_x), int(need_y), sums.data_ptr(), None if planes is None else planes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    # the blocks' sums of the map, an image's consecutive, added in the
    # reduction's fixed order: no float atomics
    if size_average:
        return sums.sum() / (N * H * W * C), planes
    return sums.view(N, -1).sum(1) / (H * W * C), planes


def ssim_backward(planes: torch.Tensor, x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                  need_x: bool, need_y: bool):
    """The backward kernel: (dL/dx or None, dL/dy or None) from the
    forward's planes, x and y, and scale [N], each image's upstream
    gradient over the floats its mean takes."""
    N, H, W, C = x.shape
    gx = torch.empty_like(x) if need_x else None
    gy = torch.empty_like(y) if need_y else None
    _launch("ssim_backward", planes.data_ptr(), x.data_ptr(), y.data_ptr(), scale.data_ptr(), N, H, W, C,
            ctypes.addressof(_taps()), int(need_x), int(need_y),
            None if gx is None else gx.data_ptr(), None if gy is None else gy.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    return gx, gy


class _SSIM(torch.autograd.Function):
    """The kernel pair as a differentiable function of contiguous x, y."""

    @staticmethod
    def forward(ctx, x, y, size_average, need_x, need_y):
        value, planes = ssim_forward(x, y, size_average, need_x, need_y)
        ctx.flags = (size_average, need_x, need_y)
        if planes is not None:
            ctx.save_for_backward(x, y, planes)
        return value

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        size_average, need_x, need_y = ctx.flags
        x, y, planes = ctx.saved_tensors
        N = x.shape[0]
        per = x[0].numel()
        scale = (g / (N * per)).expand(N) if size_average else g / per
        gx, gy = ssim_backward(planes, x, y, scale.contiguous(), need_x, need_y)
        return gx, gy, None, None, None


def _check(img1: torch.Tensor, img2: torch.Tensor, window_size: int) -> None:
    if img1.device.type != "cuda" or img2.device != img1.device:
        raise ValueError(f"ssim: tensors on {img1.device} and {img2.device} (both CPU or both on one CUDA device)")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise ValueError(f"ssim: dtypes {img1.dtype} and {img2.dtype}, expected float32")
    if img1.shape != img2.shape or img1.dim() != 4 or min(img1.shape) < 1:
        raise ValueError(f"ssim: shapes {tuple(img1.shape)} and {tuple(img2.shape)}, expected one non-empty "
                         f"[H, W, C] or [N, H, W, C]")
    if window_size != WINDOW:
        raise ValueError(f"ssim: the kernels take an {WINDOW}-tap window, not {window_size}")


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = WINDOW,
         size_average: bool = True) -> torch.Tensor:
    """Structural similarity of channel-last images [H,W,C] or [N,H,W,C]:
    the scalar mean (or per-batch [N] when size_average is False). CPU
    tensors take `ssim_plain`; CUDA tensors the kernels, or it raises."""
    if img1.device.type == "cpu" and img2.device.type == "cpu":
        return ssim_plain(img1, img2, window_size, size_average)
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    _check(img1, img2, window_size)
    grad = torch.is_grad_enabled()
    return _SSIM.apply(img1.contiguous(), img2.contiguous(), size_average,
                       grad and img1.requires_grad, grad and img2.requires_grad)


def d_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """1 - SSIM, the structural dissimilarity loss term."""
    return 1.0 - ssim(img1, img2)
