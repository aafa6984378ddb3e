"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  fused_mlp        fused MLP + softmax (CUDA C++, csrc/fused_mlp.cu);
                   replaces the Pallas kernel of
                   seldon_core_tpu/ops/fused_mlp.py
  flash_attention  flash-attention forward with log-sum-exp (CUDA C++,
                   csrc/flash_attention.cu) and its backward, dQ and dK/dV
                   (csrc/flash_attention_bwd.cu), behind a
                   torch.autograd.Function; replaces the three Pallas
                   kernels of seldon_core_tpu/ops/flash_attention.py
  flash_decode     one-token cached attention over one cache or the decode
                   lane's two tiers (CUDA C++, csrc/flash_decode.cu), and
                   over the continuous lane's paged pool through block
                   tables (flash_decode_paged, csrc/flash_decode_paged.cu),
                   both with the decode step's K/V write fused in;
                   replaces the Pallas kernel of
                   seldon_core_tpu/ops/flash_decode.py and its probe
  kv_write         in-place write of a decode step's K/V slot (on no
                   served path since the decode kernels took the write),
                   and of a prefill tick's K/V into the paged pool
                   through block tables (kv_write_paged) (CUDA C++,
                   csrc/kv_write.cu);
                   replaces the Pallas kernel of scripts/probe_inplace.py
  quant            lm_matmul, the LM layer matmul (dense only; no kernel)
  _build           nvcc build at first use + ctypes binding
"""
