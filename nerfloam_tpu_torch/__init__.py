"""nerfloam_tpu_torch: the PyTorch + CUDA port of nerfloam_tpu for one NVIDIA H100.

The JAX package ``nerfloam_tpu`` is the reference; every module here keeps
its counterpart's module and function names. The port imports torch and
numpy, never jax, yaml or anything of ``nerfloam_tpu`` (it keeps its own
numpy copy of the data loaders, of the trajectory and mesh metrics and of
the host-side vertex keys).

Geometry runs in true float32: TF32 is switched off for matmuls and cuDNN
when the package is imported (the JAX side pins Precision.HIGHEST for the
same reason, nerfloam_tpu/ops/se3.py).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
