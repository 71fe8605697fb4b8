"""Merkle tree construction (CPU reference path).

Reference: src/consensus/merkle.cpp:~45 (ComputeMerkleRoot), :~70
(BlockMerkleRoot). Consensus rule: at each level an odd node count duplicates
the last node. That duplication enables the CVE-2012-2459 mutation (a block
whose tx list ends in a duplicated pair hashes to the same root) — the
`mutated` out-flag detects identical adjacent nodes exactly like the
reference's comment block describes.

The TPU tree-reduction kernel (ops/merkle.py) is differential-tested
against this implementation.
"""

from __future__ import annotations

from ..crypto.hashes import sha256d


def compute_merkle_root(hashes: list[bytes]) -> tuple[bytes, bool]:
    """Returns (root, mutated). Empty list → zero hash like the reference."""
    if not hashes:
        return b"\x00" * 32, False
    mutated = False
    level = list(hashes)
    while len(level) > 1:
        # Mutation check runs BEFORE odd-padding: identical adjacent nodes at
        # even positions signal a CVE-2012-2459 style duplication (the padded
        # last pair is legitimately equal and must not flag).
        for i in range(0, len(level) - 1, 2):
            if level[i] == level[i + 1]:
                mutated = True
        if len(level) & 1:
            level.append(level[-1])
        level = [sha256d(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
    return level[0], mutated


def block_merkle_root(block) -> tuple[bytes, bool]:
    """BlockMerkleRoot — root over txids (src/consensus/merkle.cpp:~70)."""
    return compute_merkle_root([tx.txid for tx in block.vtx])


def merkle_root_naive(hashes: list[bytes]) -> bytes:
    """Independent recursive recomputation for tests (mirrors the reference's
    merkle_tests.cpp strategy of checking against an older algorithm)."""
    if not hashes:
        return b"\x00" * 32
    if len(hashes) == 1:
        return hashes[0]
    if len(hashes) & 1:
        hashes = hashes + [hashes[-1]]
    return merkle_root_naive(
        [sha256d(hashes[i] + hashes[i + 1]) for i in range(0, len(hashes), 2)]
    )
