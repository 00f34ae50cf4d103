"""Network trunks of the offline preprocessing stages (counterpart of
`splatter_a_video_tpu/nets/`): DINOv2 and Depth-Anything monocular
disparity, TAPIR dense tracking. Plain PyTorch in full float32 (matmuls and
convolutions, TF32 off; the JAX package computes them outside any Pallas
kernel); weights load from the converted `.npz` checkpoints the JAX
package writes, or come from each module's deterministic `random_params`.
"""
