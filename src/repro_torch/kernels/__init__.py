"""Hand-written Hopper kernels for the FedQCS hot spots.

bqcs_encode_fused (the single-pass client compressor, every codebook
family), block_topk and bqcs_encode (the staged encoder: sparsify, then
scale/project/quantize), qgamp_step (one Q-EM-GAMP iteration, EA path,
reading packed wire words) and gamp_step (one EM-GAMP iteration, AE path
and the vq EA fallback).  CUDA sources live in ``../csrc``; ``build``
compiles and binds them at first use.  Each wrapper takes its plain PyTorch
version (``ref``) for CPU tensors and launches its kernel for CUDA tensors.
Drivers live in ``ops``.
"""
