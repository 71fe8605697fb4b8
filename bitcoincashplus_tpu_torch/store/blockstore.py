"""Block and undo storage.

Reference: blk?????.dat / rev?????.dat append-only files with
(netmagic, size) framing (src/validation.cpp SaveBlockToDisk,
WriteBlockToDisk, UndoWriteToDisk), positions tracked in the block index
(CDiskBlockPos). Same design here: append-only .dat files + an in-memory
position map persisted via BlockIndexDB. Append+flush ordering before index
update is the crash-safety contract (SURVEY.md §6.3).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

MAX_BLOCKFILE_SIZE = 128 * 1024 * 1024  # 0x8000000 (MAX_BLOCKFILE_SIZE)


class MemoryBlockStore:
    """Dict-backed store for tests / ephemeral regtest nodes."""

    def __init__(self):
        self._blocks: dict[bytes, bytes] = {}
        self._undo: dict[bytes, bytes] = {}

    def put_block(self, h: bytes, raw: bytes) -> None:
        self._blocks[h] = raw

    def get_block(self, h: bytes) -> Optional[bytes]:
        return self._blocks.get(h)

    def have_block(self, h: bytes) -> bool:
        return h in self._blocks

    def put_undo(self, h: bytes, raw: bytes) -> None:
        self._undo[h] = raw

    def get_undo(self, h: bytes) -> Optional[bytes]:
        return self._undo.get(h)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class BlockStore:
    """File-backed store: blocks/blk?????.dat + rev?????.dat with
    (netmagic, u32 size) record framing, exactly the reference's on-disk
    layout. Positions are kept in memory and re-persisted by the caller
    (BlockIndexDB) — a restart reloads them from the index DB."""

    def __init__(self, datadir: str, netmagic: bytes,
                 max_file_size: int = MAX_BLOCKFILE_SIZE):
        self.dir = os.path.join(datadir, "blocks")
        os.makedirs(self.dir, exist_ok=True)
        self.netmagic = netmagic
        self.max_file_size = max_file_size
        self.positions: dict[bytes, tuple[int, int, int]] = {}  # h -> (file, offset, size)
        self.undo_positions: dict[bytes, tuple[int, int, int]] = {}
        self._files: dict[tuple[str, int], object] = {}
        self._cur_file = self._scan_last_file("blk")

    def _scan_last_file(self, prefix: str) -> int:
        n = 0
        while os.path.exists(self._path(prefix, n + 1)):
            n += 1
        return n

    def _path(self, prefix: str, n: int) -> str:
        return os.path.join(self.dir, f"{prefix}{n:05d}.dat")

    def _open(self, prefix: str, n: int):
        key = (prefix, n)
        f = self._files.get(key)
        if f is None:
            f = open(self._path(prefix, n), "a+b")
            self._files[key] = f
        return f

    def _append_to(self, prefix: str, n: int, raw: bytes) -> tuple[int, int, int]:
        """Append one (netmagic, size, raw) record to {prefix}{n}.dat."""
        f = self._open(prefix, n)
        f.seek(0, os.SEEK_END)
        record = self.netmagic + struct.pack("<I", len(raw)) + raw
        offset = f.tell() + 8  # data starts after magic+size
        f.write(record)
        return n, offset, len(raw)

    def _append(self, prefix: str, cur_attr: str, raw: bytes) -> tuple[int, int, int]:
        n = getattr(self, cur_attr)
        f = self._open(prefix, n)
        f.seek(0, os.SEEK_END)
        if f.tell() + len(raw) + 8 > self.max_file_size and f.tell() > 0:
            n += 1
            setattr(self, cur_attr, n)
        return self._append_to(prefix, n, raw)

    def _read(self, prefix: str, pos: tuple[int, int, int]) -> bytes:
        n, offset, size = pos
        f = self._open(prefix, n)
        f.seek(offset)
        return f.read(size)

    # -- public interface (shared with MemoryBlockStore) --

    def put_block(self, h: bytes, raw: bytes) -> None:
        if h in self.positions:
            return
        self.positions[h] = self._append("blk", "_cur_file", raw)

    def get_block(self, h: bytes) -> Optional[bytes]:
        pos = self.positions.get(h)
        return self._read("blk", pos) if pos else None

    def have_block(self, h: bytes) -> bool:
        return h in self.positions

    def put_undo(self, h: bytes, raw: bytes) -> None:
        if h in self.undo_positions:
            return
        # undo lives in the rev file PAIRED with the block's blk file
        # (UndoWriteToDisk uses the block's nFile) — pruning blk{n}+rev{n}
        # as a unit then can't orphan undo data of unpruned blocks
        blockpos = self.positions.get(h)
        n = blockpos[0] if blockpos is not None else self._cur_file
        self.undo_positions[h] = self._append_to("rev", n, raw)

    def get_undo(self, h: bytes) -> Optional[bytes]:
        pos = self.undo_positions.get(h)
        return self._read("rev", pos) if pos else None

    def flush(self) -> None:
        """fsync data files BEFORE the index/chainstate batch commits —
        the reference's FlushBlockFile ordering."""
        for f in self._files.values():
            f.flush()
            os.fsync(f.fileno())

    # -- pruning (UnlinkPrunedFiles, src/validation.cpp) -----------------

    def blocks_in_file(self, n: int) -> list[bytes]:
        return [h for h, pos in self.positions.items() if pos[0] == n]

    def file_usage(self) -> int:
        """Total bytes across all blk/rev files (CalculateCurrentUsage)."""
        total = 0
        for prefix in ("blk", "rev"):
            i = 0
            while True:
                path = self._path(prefix, i)
                if not os.path.exists(path):
                    break
                total += os.path.getsize(path)
                i += 1
        return total

    def prune_file(self, n: int) -> list[bytes]:
        """Delete blk{n} (and rev{n} when safe) and forget the pruned
        blocks' positions. Returns the block hashes whose data was removed
        (caller clears index status). The current append file is never
        pruned."""
        if n >= self._cur_file:
            return []
        removed = set(self.blocks_in_file(n))
        truncate = ["blk"]
        # rev{n} normally holds exactly file-n blocks' undo (put_undo pairs
        # them), but a pre-pairing datadir can have foreign undo records in
        # it — truncating then would orphan undo of unpruned blocks, so
        # only the positions of pruned blocks are dropped in that case
        undo_in_rev_n = {h for h, p in self.undo_positions.items()
                         if p[0] == n}
        if undo_in_rev_n <= removed:
            truncate.append("rev")
        for prefix in truncate:
            f = self._files.pop((prefix, n), None)
            if f is not None:
                f.close()
            path = self._path(prefix, n)
            if os.path.exists(path):
                # truncate-in-place rather than unlink: _scan_last_file
                # relies on contiguous file numbering at startup
                with open(path, "wb"):
                    pass
        self.positions = {h: p for h, p in self.positions.items()
                          if h not in removed}
        self.undo_positions = {h: p for h, p in self.undo_positions.items()
                               if h not in removed}
        return list(removed)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
