"""Block index and active chain.

Reference: src/chain.{h,cpp} (CBlockIndex, CChain, GetSkipHeight /
CBlockIndex::GetAncestor skip-list, GetMedianTimePast), src/chain.cpp:~120
(GetBlockProof via pow.get_block_proof).
"""

from __future__ import annotations

from enum import IntFlag
from typing import Optional

from ..consensus.block import CBlockHeader
from ..consensus.pow import get_block_proof

MEDIAN_TIME_SPAN = 11  # CBlockIndex::nMedianTimeSpan


class BlockStatus(IntFlag):
    """Validity progression + data flags — enum BlockStatus (src/chain.h)."""

    VALIDITY_UNKNOWN = 0
    VALID_HEADER = 1  # PoW + header sanity
    VALID_TREE = 2  # parent found, contextual header rules
    VALID_TRANSACTIONS = 3  # CheckBlock passed (merkle, tx sanity)
    VALID_CHAIN = 4  # ConnectBlock non-script rules passed
    VALID_SCRIPTS = 5  # full script/signature validation
    VALID_MASK = 7
    HAVE_DATA = 8
    HAVE_UNDO = 16
    FAILED_VALID = 32
    FAILED_CHILD = 64
    FAILED_MASK = FAILED_VALID | FAILED_CHILD


def _skip_height(height: int) -> int:
    """GetSkipHeight (src/chain.cpp:~70): pointer-jump target making
    get_ancestor O(log n). Exact reference formula."""
    if height < 2:
        return 0

    def invert_lowest_one(n: int) -> int:
        return n & (n - 1)

    if height & 1:
        return invert_lowest_one(invert_lowest_one(height - 1)) + 1
    return invert_lowest_one(height)


class CBlockIndex:
    """One entry of the in-memory block tree — CBlockIndex (src/chain.h)."""

    __slots__ = (
        "header",
        "hash",
        "prev",
        "skip",
        "height",
        "chain_work",
        "status",
        "n_tx",
        "chain_tx",
        "sequence_id",
    )

    def __init__(self, header: CBlockHeader, block_hash: Optional[bytes] = None,
                 prev: Optional["CBlockIndex"] = None):
        self.header = header
        self.hash = block_hash if block_hash is not None else header.get_hash()
        self.prev = prev
        self.height = 0 if prev is None else prev.height + 1
        self.skip: Optional[CBlockIndex] = (
            None if prev is None else prev.get_ancestor(_skip_height(self.height))
        )
        self.chain_work = (0 if prev is None else prev.chain_work) + get_block_proof(
            header.bits
        )
        self.status = BlockStatus.VALIDITY_UNKNOWN
        self.n_tx = 0
        # nChainTx analogue: cumulative tx count genesis..here; 0 means some
        # ancestor (or this block) is missing data — such indexes must NOT
        # become connect candidates (the reference gates
        # setBlockIndexCandidates on nChainTx, src/validation.cpp).
        self.chain_tx = 0
        self.sequence_id = 0  # tie-break: earlier-received wins (validation.cpp)

    # -- reference accessors --

    @property
    def time(self) -> int:
        return self.header.time

    @property
    def bits(self) -> int:
        return self.header.bits

    def get_ancestor(self, height: int) -> Optional["CBlockIndex"]:
        """CBlockIndex::GetAncestor — skip-list walk, O(log n)."""
        if height > self.height or height < 0:
            return None
        walk = self
        while walk.height > height:
            hs = _skip_height(walk.height)
            if walk.skip is not None and (
                hs == height
                or (
                    hs > height
                    and not (
                        walk.height - hs < walk.height - height
                        and hs < height + (walk.height - height) // 2
                    )
                )
            ):
                walk = walk.skip
            else:
                walk = walk.prev
        return walk

    def get_median_time_past(self) -> int:
        """Median of the last 11 block times — GetMedianTimePast."""
        times = []
        idx = self
        for _ in range(MEDIAN_TIME_SPAN):
            if idx is None:
                break
            times.append(idx.time)
            idx = idx.prev
        times.sort()
        return times[len(times) // 2]

    def is_valid(self, up_to: BlockStatus = BlockStatus.VALID_TRANSACTIONS) -> bool:
        """IsValid(nUpTo) — validity reached and not failed."""
        if self.status & BlockStatus.FAILED_MASK:
            return False
        return (self.status & BlockStatus.VALID_MASK) >= up_to

    def raise_validity(self, up_to: BlockStatus) -> bool:
        if self.status & BlockStatus.FAILED_MASK:
            return False
        if (self.status & BlockStatus.VALID_MASK) < up_to:
            self.status = (self.status & ~BlockStatus.VALID_MASK) | up_to
            return True
        return False

    def __repr__(self):
        return f"CBlockIndex(height={self.height}, hash={self.hash[::-1].hex()[:16]}...)"


class CChain:
    """The active chain as a height-indexed vector — CChain (src/chain.h)."""

    def __init__(self):
        self._chain: list[CBlockIndex] = []

    def genesis(self) -> Optional[CBlockIndex]:
        return self._chain[0] if self._chain else None

    def tip(self) -> Optional[CBlockIndex]:
        return self._chain[-1] if self._chain else None

    def __getitem__(self, height: int) -> Optional[CBlockIndex]:
        if 0 <= height < len(self._chain):
            return self._chain[height]
        return None

    def __contains__(self, index: CBlockIndex) -> bool:
        return self[index.height] is index

    def height(self) -> int:
        return len(self._chain) - 1

    def set_tip(self, index: Optional[CBlockIndex]) -> None:
        """CChain::SetTip — rebuild the vector back from the new tip."""
        if index is None:
            self._chain = []
            return
        self._chain += [None] * (index.height + 1 - len(self._chain))
        del self._chain[index.height + 1:]
        while index is not None and self._chain[index.height] is not index:
            self._chain[index.height] = index
            index = index.prev

    def next(self, index: CBlockIndex) -> Optional[CBlockIndex]:
        if index in self:
            return self[index.height + 1]
        return None

    def find_fork(self, index: Optional[CBlockIndex]) -> Optional[CBlockIndex]:
        """CChain::FindFork — last common ancestor with the active chain."""
        if index is None:
            return None
        if index.height > self.height():
            index = index.get_ancestor(self.height())
        while index is not None and index not in self:
            index = index.prev
        return index

    def get_locator(self, index: Optional[CBlockIndex] = None) -> list[bytes]:
        """CChain::GetLocator — exponentially-spaced hash list for P2P sync."""
        if index is None:
            index = self.tip()
        hashes = []
        step = 1
        while index is not None:
            hashes.append(index.hash)
            if index.height == 0:
                break
            h = max(index.height - step, 0)
            if index in self:
                index = self[h]
            else:
                index = index.get_ancestor(h)
            if len(hashes) > 10:
                step *= 2
        return hashes
