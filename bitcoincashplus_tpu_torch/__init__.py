"""bitcoincashplus_tpu_torch — the PyTorch/CUDA port of bitcoincashplus_tpu.

A second package beside the JAX reference (``bitcoincashplus_tpu``), for
one NVIDIA H100 (sm_90a). It keeps the reference's module layout, so each
module's counterpart is found under the same relative path. It imports
``torch`` and numpy, never ``jax``, and nothing of the reference package.

Ported so far (block validation with ``-ecdsakernel=w4``; block mining):

- consensus/, crypto/, script/, store/, validation/, wallet/, util/ and
  native.py: host modules, copied from the reference (the drift test
  ``tests/test_torch_isolation.py`` lists every deliberate difference);
- util/devicewatch.py: program shape budgets, phases, transfers and the
  stall watchdog, without the jax compile-cache and profiler hooks;
- ops/dispatch.py: circuit breakers and supervised calls (host Merkle);
- ops/secp256k1.py: the w4 batch ECDSA verify — a hand-written CUDA
  kernel (csrc/w4_verify.cu) for both Pallas w4 entry points, and its
  plain PyTorch version;
- ops/ecdsa_batch.py: the w4 rung of the supervised dispatch, the packed
  (native engine) path, BatchHandle, LanePacker;
- ops/sha256_sweep.py, ops/pallas_sweep.py, ops/miner.py: the SHA-256d
  nonce sweeps — a hand-written CUDA file (csrc/sha256d_sweep.cu) for the
  Pallas h7 sweep and the h7 and exact sweep programs, and their plain
  PyTorch versions;
- mining/: block assembly and generate_blocks (host copies) and the
  resident mining loop on a CUDA stream;
- workload/sigchain.py: the signature-dense regtest chain generator.

Entry points run on ``cuda`` unless the caller selects the CPU device
(``ops.cuda_build.set_device("cpu")``), as the tests do.
"""

__version__ = "0.1.0"
