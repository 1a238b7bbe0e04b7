"""MIPSFusion in PyTorch with hand-written CUDA kernels for the H100.

A port of ``mipsfusion_tpu`` (the JAX/Pallas package, kept beside it as
the reference). Slice 1 covers the single-submap SLAM loop
(``slam.system.MIPSFusionTorch`` with ``use_manager: False``) on the
Triplane+CP field; the four field kernels (fused forward, decoder
backward, plane backward, coordinate backward) are CUDA C++ for
``sm_90a`` under ``csrc/``, each with a plain PyTorch version beside it
that serves CPU tensors.

Precision: every kernel stores in float32 and keeps float32 accuracy
(K2's tensor-core products split each operand into two TF32 parts), and
TF32 is off for PyTorch's matmuls and convolutions — the port's form of
the reference's full-precision pose-math rule.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
