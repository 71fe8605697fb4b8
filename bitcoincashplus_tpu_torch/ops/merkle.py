"""Merkle roots and flat pair levels on the card (K2).

Port of the reference's ops/merkle.py. It replaces
src/consensus/merkle.cpp:~45 (ComputeMerkleRoot)'s serial pairwise loop
with a lane-parallel tree reduction: each level hashes all digest pairs
at once (double-SHA of the 64-byte concatenation, 3 compressions), log2(n)
levels in all.

Consensus-exact odd handling: when a level has an odd node count the LAST
node is paired with itself (the CVE-2012-2459 duplication rule) — a masked
select on the live count ``m``, never power-of-two padding, because
padding changes the tree shape for non-pow2 counts. The bucket (a power
of two, at least PAD_LANES leaves) bounds the launch shapes; the lanes
past ``m`` are zeros that never reach a live node. The mutation flag
covers the known Merkle "mutation" (two identical hashes forming a live
pair), which CheckBlock's duplicate-tx rule reads.

- **The kernels** (``csrc/sha256d_batch.cu``, CUDA C++ for sm_90a, built
  and bound by ops/cuda_build.py): ``merkle_tree`` replaces the XLA program
  ``_tree_reduce_jit`` (the whole tree: a block reduces 8 or more levels
  of a subtree in shared memory, and the block that finishes last the
  levels above them, one launch up to 2^16 leaves), and
  ``hash_pairs_words`` replaces ``_hash_pairs_jit`` (one flat level, the
  certificate MMR's). Each takes its plain version only for a tensor on
  the CPU; for a CUDA tensor it launches the kernel or raises
  ``KernelUnavailable`` — it never falls back.
- **The plain versions** ``tree_reduce_plain`` (a line-for-line torch
  version of ``_tree_reduce_jit``) and ``hash_pairs_plain``, on int64
  tensors holding 32-bit words.
- **The host API** ``compute_merkle_root_tpu_ex`` and ``sha256d_pairs``,
  the reference's, supervised at the ``merkle`` site with the pair-0
  witness checked on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .cuda_build import KernelUnavailable, require_device
from .sha256 import check_words, sha256d_64, words32, words64

PAD_LANES = 128  # the bucket floor: keeps distinct launch shapes ~O(log n)
# The tree kernel's launch plan (csrc/sha256d_batch.cu's merkle_tree):
# up to 2 * TREE_LEVELS levels one launch, in which at most
# 2**TREE_BLOCKS_LOG2 blocks of at least TREE_LEVELS levels each (one an
# SM) reduce the lower levels and the last of them the levels above; a
# deeper tree first chains launches of TREE_LEVELS levels a block.
TREE_LEVELS = 8
TREE_BLOCKS_LOG2 = 7
TREE_WORDS = 17  # the tree's output: the root (8), mutated (1), the witness (8)

# Launches per wrapper: each adds one where it launches its kernel, and
# nowhere else (the plain version does not count). A call of the C entry
# is counted once, whatever its kernel launches.
LAUNCHES = {"merkle_tree": 0, "sha256d_pairs": 0}

_VP, _I32, _I64, _U64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_uint64)
ENTRY_ARGS = {
    # (leaves, n_levels, m, scratch, scratch_nodes, tickets, out, stream)
    "merkle_tree": [_VP, _I32, _U64, _VP, _I64, _VP, _VP, _VP],
    # (rows, n, out, stream)
    "sha256d_pairs": [_VP, _I64, _VP, _VP],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digests_to_words(digests: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 digests -> (N, 8) uint32 BE words."""
    return digests.reshape(-1, 8, 4).view(">u4").squeeze(-1).astype(np.uint32)


def _words_to_digests(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(words).astype(">u4").view(np.uint8).reshape(-1, 32)


def _to_device(words: np.ndarray, dev) -> torch.Tensor:
    """Host uint32 words -> an int32 bit-pattern tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(dev)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# ---- the plain versions -----------------------------------------------------

def tree_reduce_plain(words: torch.Tensor, n_levels: int, m: int):
    """The plain version of ``merkle_tree``: ``_tree_reduce_jit`` line for
    line on words' device. words: (2**n_levels, 8) int32 leaf words; m the
    live count. Returns (root (8,) int32, mutated 0-d bool, witness (8,)
    int32)."""
    level = list(words64(words).unbind(1))  # column-major: 8 tensors (B,)
    dev = words.device
    mutated = torch.zeros((), dtype=torch.bool, device=dev)
    witness = None  # first-level pair-0 hash — the host validation probe
    for k in range(n_levels):
        half = 1 << (n_levels - k - 1)
        pair_idx = torch.arange(half, dtype=torch.int64, device=dev)
        left = [c[0::2] for c in level]
        right = [c[1::2] for c in level]
        equal = torch.ones((half,), dtype=torch.bool, device=dev)
        for l_col, r_col in zip(left, right):
            equal &= l_col == r_col
        live_pair = 2 * pair_idx + 1 < m  # both nodes inside the prefix
        mutated |= torch.any(equal & live_pair)
        dup = 2 * pair_idx + 1 >= m  # odd tail (and dead lanes): self-pair
        right = [torch.where(dup, l_col, r_col)
                 for l_col, r_col in zip(left, right)]
        hashed = sha256d_64(left + right)
        if k == 0:
            witness = torch.stack([c[0] for c in hashed], dim=-1)
        # once the live count reaches 1 the root rides through untouched
        done = m <= 1
        level = left if done else hashed
        m = m if done else (m + 1) // 2
    root = torch.stack(level, dim=-1)[0]
    return words32(root), mutated, words32(witness)


def hash_pairs_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of ``hash_pairs_words``: (N, 16) int32 rows ->
    (N, 8) int32 digests."""
    return words32(torch.stack(sha256d_64(list(words64(rows).unbind(1))),
                               dim=1))


# ---- the kernel entries -----------------------------------------------------

def _launch(name: str, dev: torch.device, *args) -> None:
    cuda_build.launch(name, ENTRY_ARGS[name], dev, *args)
    LAUNCHES[name] += 1


# The tree kernel's ticket counters, one for each (device, stream): zeroed
# here once, left zero by every call (the block that draws the last
# ticket resets it), so calls on one stream, which run in order, share
# one, and calls on two streams never do.
_TICKETS: dict = {}


def _tickets(dev: torch.device) -> torch.Tensor:
    stream = torch.cuda.current_stream(dev)
    key = (stream.device_index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def merkle_tree_words(words: torch.Tensor, n_levels: int,
                      m: int) -> torch.Tensor:
    """The whole tree over (2**n_levels, 8) int32 leaf words with ``m``
    live, on words' device, as the kernel writes it: (TREE_WORDS,) int32,
    the root (8 words), mutated (1: 0 or 1) and the witness (8: the hash
    of level-1 pair 0), so that a caller reads all three in one copy."""
    check_words(words, 8, "leaf words")
    if n_levels < 1 or words.shape[0] != 1 << n_levels:
        raise ValueError(f"{words.shape[0]} leaves is not a bucket of "
                         f"2**{n_levels}")
    if not 0 <= m <= 0xFFFFFFFF:
        raise ValueError(f"live count {m} is not a u32")
    dev = words.device
    if dev.type == "cpu":
        root, mutated, witness = tree_reduce_plain(words, n_levels, m)
        return torch.cat([root, mutated.to(torch.int32).reshape(1), witness])
    if dev.type != "cuda":
        raise KernelUnavailable(f"no Merkle kernel for device {dev}")
    scratch_nodes = 1 << max(0, n_levels - TREE_LEVELS)
    scratch = torch.empty(2 * scratch_nodes * 9, dtype=torch.int32,
                          device=dev)
    out = torch.empty(TREE_WORDS, dtype=torch.int32, device=dev)
    _launch("merkle_tree", dev, words.data_ptr(), n_levels, m,
            scratch.data_ptr(), scratch_nodes, _tickets(dev).data_ptr(),
            out.data_ptr())
    return out


def merkle_tree(words: torch.Tensor, n_levels: int, m: int):
    """K2's contract (the reference's _tree_reduce_jit) over
    ``merkle_tree_words``: (root (8,) int32, mutated 0-d bool, witness (8,)
    int32, the hash of level-1 pair 0)."""
    out = merkle_tree_words(words, n_levels, m)
    return out[:8], out[8] != 0, out[9:]


def hash_pairs_words(rows: torch.Tensor) -> torch.Tensor:
    """(N, 16) int32 rows, each a 64-byte left || right, -> (N, 8) int32
    sha256d digests on rows' device (the reference's _hash_pairs_jit)."""
    check_words(rows, 16, "pair rows")
    dev = rows.device
    if dev.type == "cpu":
        return hash_pairs_plain(rows)
    if dev.type != "cuda":
        raise KernelUnavailable(f"no pair-hash kernel for device {dev}")
    out = torch.empty((rows.shape[0], 8), dtype=torch.int32, device=dev)
    if rows.shape[0]:
        _launch("sha256d_pairs", dev, rows.data_ptr(), rows.shape[0],
                out.data_ptr())
    return out


# ---- the host API -----------------------------------------------------------

def sha256d_pairs(pairs: list[bytes]) -> list[bytes]:
    """Batched sha256d over 64-byte concatenations — the level primitive
    the snapshot-certificate MMR builds on. Small batches take the host
    loop outright (launch latency dominates); large ones ride the
    supervised ``merkle`` subsystem with the same poisoned-output witness
    discipline as the block-Merkle tree: pair 0 is recomputed on the host
    in 2 hashes; an injected fault degrades to the CPU loop with the
    result unchanged, any other device failure raises."""
    from ..crypto.hashes import sha256d
    from ..util import devicewatch as dw
    from . import dispatch

    n = len(pairs)
    if n == 0:
        return []
    if n < PAD_LANES:
        return [sha256d(p) for p in pairs]

    def device():
        bucket = -(-n // PAD_LANES) * PAD_LANES
        words = np.frombuffer(b"".join(pairs), dtype=np.uint8) \
            .reshape(-1, 16, 4).view(">u4").squeeze(-1).astype(np.uint32)
        if bucket != n:
            words = np.concatenate(
                [words, np.zeros((bucket - n, 16), dtype=np.uint32)], axis=0)
        dev = require_device("the pair hash")
        dw.note_transfer("merkle", "h2d", int(words.nbytes))
        # PAD_LANES buckets bound the launch shapes exactly like the
        # tree path; the budget mirrors merkle_tree's pow2 rationale
        with dw.program("merkle_pairs", shape_budget=24).dispatch(bucket):
            out = hash_pairs_words(_to_device(words, dev))
        out = _to_host(out)[:n]
        dw.note_transfer("merkle", "d2h", int(out.nbytes))
        return [d.tobytes() for d in _words_to_digests(out)]

    out, _used_device = dispatch.supervised_call(
        "merkle", device, lambda: [sha256d(p) for p in pairs],
        validate=lambda res: res[0] == sha256d(pairs[0]),
        poison=lambda res: [bytes(b ^ 0xFF for b in res[0])] + res[1:],
        items=n,
    )
    return out


def compute_merkle_root_tpu(hashes: list[bytes]) -> tuple[bytes, bool]:
    """Drop-in for consensus.merkle.compute_merkle_root on large inputs
    (see compute_merkle_root_tpu_ex for the full contract)."""
    root, mutated, _used_device = compute_merkle_root_tpu_ex(hashes)
    return root, mutated


def compute_merkle_root_tpu_ex(hashes: list[bytes]) -> tuple:
    """Supervised device Merkle root: (root, mutated, used_device) —
    used_device is False whenever the CPU reference produced the result
    (small input, or an injected fault), letting callers skip their own
    CPU confirmation.

    The whole log2(n)-level tree is one call of the tree kernel; its
    launch shapes are bounded by the number of distinct pow2 buckets, not
    tx counts.

    Supervised (ops/dispatch): the device also returns the level-1 pair-0
    node, which the host recomputes in 2 hashes — a device that did not
    really run the SHA rounds (or a poisoned output) is caught: under an
    injected fault the call degrades to the CPU reference loop, verdict
    unchanged; otherwise it raises KernelUnavailable.
    """
    from ..consensus.merkle import compute_merkle_root
    from ..crypto.hashes import sha256d
    from . import dispatch

    if not hashes:
        return b"\x00" * 32, False, False
    if len(hashes) == 1:
        return hashes[0], False, False
    n = len(hashes)

    def device():
        from ..util import devicewatch as dw

        bucket = max(PAD_LANES, 1 << (n - 1).bit_length())
        words = _digests_to_words(
            np.frombuffer(b"".join(hashes), dtype=np.uint8).reshape(-1, 32)
        )
        if bucket != n:
            words = np.concatenate(
                [words, np.zeros((bucket - n, 8), dtype=np.uint32)], axis=0
            )
        dev = require_device("the Merkle tree")
        # watched dispatch: pow2 buckets bound the launch shapes to one
        # per level count — the budget is the plausible pow2 range (2^7
        # leaf floor .. 2^30), so a padding regression that starts
        # launching per-tx-count shapes fires the sentinel
        dw.note_transfer("merkle", "h2d", int(words.nbytes))
        with dw.program("merkle_tree", shape_budget=24).dispatch(bucket):
            # one device-to-host copy of the 17 words, split on the host
            out = _to_host(merkle_tree_words(
                _to_device(words, dev), bucket.bit_length() - 1, n))
        dw.note_transfer("merkle", "d2h", int(out.nbytes))
        return (_words_to_digests(out[None, :8])[0].tobytes(), bool(out[8]),
                _words_to_digests(out[None, 9:])[0].tobytes())

    def validate(res) -> bool:
        _root, _mut, witness = res
        return witness == sha256d(hashes[0] + hashes[1])

    def poison(res):
        root, mut, witness = res
        flip = bytes(b ^ 0xFF for b in root)
        return flip, mut, bytes(b ^ 0xFF for b in witness)

    out, used_device = dispatch.supervised_call(
        "merkle", device, lambda: compute_merkle_root(hashes),
        validate=validate, poison=poison, items=n,
    )
    if used_device:
        root, mutated, _witness = out
        return root, mutated, True
    root, mutated = out
    return root, mutated, False
