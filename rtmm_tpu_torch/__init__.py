"""PyTorch/CUDA port of the rtmm_tpu micro-mesh ray tracer (NVIDIA Hopper).

All device work is float32. TF32 is switched off here, where the package
initialises, for matrix products and cuDNN alike, so that no float32
operation of the port silently runs with a 10-bit mantissa.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
