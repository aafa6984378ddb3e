"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  fused_mlp   fused MLP + softmax (CUDA C++, csrc/fused_mlp.cu); replaces
              the Pallas kernel of seldon_core_tpu/ops/fused_mlp.py
  _build      nvcc build at first use + ctypes binding
"""
