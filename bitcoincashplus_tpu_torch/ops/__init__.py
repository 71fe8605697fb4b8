"""Device compute for the port (PyTorch + hand-written CUDA for sm_90a).

- cuda_build.py — the device switch, the one-library nvcc build of every
  csrc/*.cu, and the fault classification (KernelUnavailable).
- secp256k1.py / ecdsa_batch.py — batch ECDSA verification: the w4 kernel
  (csrc/w4_verify.cu) behind the supervised dispatch.
- sha256.py / sha256_sweep.py / pallas_sweep.py / miner.py — the
  SHA-256d nonce sweeps of the miner (csrc/sha256d_sweep.cu).
- dispatch.py — circuit breakers and supervised calls.

Kernels are built at first use (nvcc into build/torch_kernels/); nothing
is compiled or launched at import.
"""
