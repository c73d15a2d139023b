"""Hand-written Hopper kernels for the FedQCS hot spots.

bqcs_encode_fused (the single-pass client compressor), qgamp_step (one
Q-EM-GAMP iteration, EA path, reading packed wire words) and gamp_step (one
EM-GAMP iteration, AE path).  CUDA sources live in ``../csrc``; ``build``
compiles and binds them at first use.  Each wrapper takes its plain PyTorch
version (``ref``) for CPU tensors and launches its kernel for CUDA tensors.
Drivers live in ``ops``.
"""
