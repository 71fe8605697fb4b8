"""Multi-chip parallelism over a jax.sharding.Mesh.

The reference's only intra-node parallelism is shared-memory threads
(src/checkqueue.h CCheckQueue; SURVEY.md §3.2). Here the equivalents are
SPMD over a ('chip',) mesh with XLA collectives riding ICI:

  - nonce_shard.py — the 32-bit PoW nonce space sharded across chips
    (P2 in SURVEY.md §3.2): each chip sweeps a contiguous range, hit
    reduction via psum/argmin of (found, nonce).
  - The ECDSA batch axis (P1) shards the same way in ops/ecdsa_batch.py.

Tests exercise these on a virtual 8-device CPU mesh
(xla_force_host_platform_device_count); the driver's dryrun_multichip does
the same, and real runs use the v5e-8 ICI ring.
"""

from .mesh import chip_mesh, device_count

__all__ = ["chip_mesh", "device_count"]
