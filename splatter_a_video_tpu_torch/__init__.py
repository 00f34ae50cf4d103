"""PyTorch/CUDA port of `splatter_a_video_tpu` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference the port is tested
against; this package imports none of it (nor JAX itself). Entry points
run on the GPU unless the caller passes `device="cpu"`; on the CPU every
hand-written CUDA kernel is replaced by its plain PyTorch version.

Precision pin (counterpart of `splatter_a_video_tpu/__init__.py:27-48`):
single-pass reduced-precision matmuls collapsed training in the
reference, and on Hopper that risk is TF32. Matmuls and cuDNN
convolutions stay in full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
