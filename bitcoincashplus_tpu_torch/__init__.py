"""bitcoincashplus_tpu_torch — the PyTorch/CUDA port of bitcoincashplus_tpu.

A second package beside the JAX reference (``bitcoincashplus_tpu``), for
one NVIDIA H100 (sm_90a). It keeps the reference's module layout, so each
module's counterpart is found under the same relative path. It imports
``torch`` and numpy, never ``jax``, and nothing of the reference package.

Ported so far (block validation under every ECDSA kernel and the Schnorr
batch check; the node's -reindex; block mining):

- consensus/, crypto/, script/, store/, validation/, wallet/, util/,
  mempool/, serving/, node/ and native.py: host modules, copied from the
  reference (the drift test ``tests/test_torch_isolation.py`` lists every
  deliberate difference; node/node.py loses the reference's jax CPU pin);
- util/devicewatch.py: program shape budgets, phases, transfers, the
  stall watchdog and the compile cache (the kernel library directory),
  without the profiler hooks;
- ops/dispatch.py: circuit breakers and supervised calls (host Merkle);
- ops/secp256k1.py: the batch ECDSA verifies (w4, GLV, the bit ladder)
  and the Schnorr MSM — hand-written CUDA kernels (csrc/*.cu) and their
  plain PyTorch versions;
- ops/ecdsa_batch.py: the supervised dispatch's rungs (GLV, w4, the bit
  ladder under BCP_SECP_PALLAS=0, the MSM), the packed (native engine)
  path, BatchHandle, LanePacker;
- ops/sha256_sweep.py, ops/pallas_sweep.py, ops/miner.py: the SHA-256d
  nonce sweeps — a hand-written CUDA file (csrc/sha256d_sweep.cu) for the
  Pallas h7 sweep and the h7 and exact sweep programs, and their plain
  PyTorch versions;
- mining/: block assembly and generate_blocks (host copies) and the
  resident mining loop on a CUDA stream;
- workload/sigchain.py: the signature-dense regtest chain generator, its
  reader, its validation run (validate_chain) and the node's -reindex in
  process (reindex).

Entry points run on ``cuda`` unless the caller selects the CPU device
(``ops.cuda_build.set_device("cpu")``), as the tests do.
"""

__version__ = "0.1.0"
