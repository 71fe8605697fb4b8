"""Device compute for the port (PyTorch + hand-written CUDA for sm_90a).

- secp256k1.py / ecdsa_batch.py — batch ECDSA verification: the w4 kernel
  (csrc/w4_verify.cu) behind the supervised dispatch.
- dispatch.py — circuit breakers and supervised calls.

Kernels are built at first use (nvcc into build/torch_kernels/); nothing
is compiled or launched at import.
"""
