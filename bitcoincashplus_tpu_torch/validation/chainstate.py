"""The consensus state machine — ChainstateManager.

Reference: src/validation.cpp. Function-by-function parity (SURVEY.md §3.1):
ProcessNewBlock (:~3100), AcceptBlock (:~3000), AcceptBlockHeader,
CheckBlock, ConnectBlock (:~1700), DisconnectBlock, ActivateBestChain
(:~2500), InvalidateBlock, FlushStateToDisk (:~1900).

Differences from the reference, by design (TPU-first, SURVEY.md §1):
  - Single-threaded host orchestration (no cs_main; Python + asyncio).
  - Script/signature checks are not fanned out to a thread pool
    (CCheckQueue); they are *deferred* into per-block batch records and
    dispatched to the TPU ECDSA kernel in one shot (ops/ecdsa_batch), with
    a CPU fallback. The `script_verifier` hook owns that policy.
  - Header PoW / Merkle recomputation can run batched on-chip.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

from ..consensus.block import CBlock, CBlockHeader
from ..consensus.params import ChainParams, get_block_subsidy
from ..consensus.pow import check_proof_of_work, get_next_work_required
from ..consensus.serialize import hash_to_hex
from ..consensus.tx import COutPoint, CTransaction, money_range
from ..consensus.tx_check import TxValidationError, check_transaction, is_final_tx
from ..script.script import script_int
from ..util import devicewatch as dw
from ..util import telemetry as tm
from ..util.log import log_print
from .chain import BlockStatus, CBlockIndex, CChain
from .coins import BlockUndo, CoinsCache, CoinsView, TxUndo, add_coins

MAX_FUTURE_BLOCK_TIME = 2 * 60 * 60  # src/chain.h (MAX_FUTURE_BLOCK_TIME)

# -- telemetry (util/telemetry): the pipelined engine's per-block leg
# latencies as histograms, and scan/settle/commit spans so a -tracefile
# dump yields a MEASURED per-block overlap fraction (tools/trace_view.py)
# instead of the bench-only aggregate estimate.
_SCAN_H = tm.histogram(
    "bcp_pipeline_scan_seconds",
    "Speculative connect + host script scan per block")
_SETTLE_H = tm.histogram(
    "bcp_pipeline_settle_wait_seconds",
    "Blocking wait for a block's signature batches at settle")
_COMMIT_H = tm.histogram(
    "bcp_pipeline_commit_seconds",
    "Externalization (coins merge, undo+index write, listeners) per block")
_UNWINDS_C = tm.counter(
    "bcp_pipeline_unwind_blocks_total",
    "Speculative blocks dropped by settle-failure unwinds")
# -- speculation-tree observability (ISSUE 9): reorg accounting plus the
# per-branch shape of the settle horizon once competing tips validate
# concurrently. A "reorg" here is the externalized kind — settled blocks
# disconnected from the active chain; in-tree branch switches never
# disconnect anything and are counted as branch drops instead.
_REORGS_C = tm.counter(
    "bcp_reorgs_total",
    "Active-chain reorganizations (settled blocks disconnected)")
_REORG_DEPTH_H = tm.histogram(
    "bcp_reorg_depth",
    "Settled blocks disconnected per reorg",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64))
_BRANCHES_G = tm.gauge(
    "bcp_spec_branches",
    "Live branches (leaves) in the speculation tree")
_LAYERS_G = tm.gauge(
    "bcp_spec_layers",
    "Speculative coin-cache layers live across all branches")
_BRANCH_DROPS_C = tm.counter(
    "bcp_spec_branch_drops_total",
    "Losing speculative branches dropped (never externalized)")


class BlockValidationError(TxValidationError):
    """Block-level reject reason (shares the reason-string contract)."""


# Type of the deferred script-verification hook: called once per block with
# (block, index, spent_coins_per_input) and must raise BlockValidationError
# on failure. Wired to the script interpreter + TPU sig batch in
# validation/scriptcheck.py. The DEFAULT is fail-closed: a
# BlockScriptVerifier is constructed unless the caller explicitly passes
# None (below-assumevalid / trusted-reindex behavior — the reference's
# fScriptChecks=false path, src/validation.cpp ConnectBlock).
ScriptVerifier = Callable[[CBlock, CBlockIndex, list], None]

_DEFAULT = object()  # sentinel: "build the real verifier"


class ChainstateManager:
    """Owns the block tree, the active chain, and the UTXO view stack."""

    def __init__(
        self,
        params: ChainParams,
        coins_base: CoinsView,
        block_store,
        script_verifier=_DEFAULT,
        get_time: Callable[[], int] = lambda: int(_time.time()),
        index_db=None,
    ):
        if script_verifier is _DEFAULT:
            from .scriptcheck import BlockScriptVerifier

            script_verifier = BlockScriptVerifier(params)
        # startup replay/rollback: a journaled coins store (CoinsDB with a
        # journal path) may hold a commit that crashed mid-flight; resolve
        # it to a whole pre- or post-batch state BEFORE anything reads the
        # best-block marker (store/chainstatedb.py commit-journal contract)
        recover = getattr(coins_base, "recover_journal", None)
        if recover is not None and recover():
            log_print("db", "chainstate commit journal replayed at startup")
        self.params = params
        self.chain = CChain()
        self.block_index: dict[bytes, CBlockIndex] = {}
        self.coins = CoinsCache(coins_base)
        self.block_store = block_store
        self.index_db = index_db  # BlockIndexDB or None (ephemeral nodes)
        self.script_verifier = script_verifier
        self.get_time = get_time
        self._candidates: set[CBlockIndex] = set()  # setBlockIndexCandidates
        self._seq = 0
        self._precious_seq = 0  # PreciousBlock's nBlockReverseSequenceId
        self._invalid: set[CBlockIndex] = set()
        # setDirtyBlockIndex analogue: indexes whose on-disk record is stale
        self._dirty_index: set[CBlockIndex] = set()
        # mapBlocksUnlinked analogue: children with data whose ancestor path
        # is missing data; relinked when the gap block arrives.
        self._unlinked: dict[CBlockIndex, list[CBlockIndex]] = {}
        # notification hooks (CMainSignals analogue — validationinterface)
        self.on_block_connected: list[Callable] = []
        self.on_block_disconnected: list[Callable] = []
        self.on_tip_changed: list[Callable] = []
        # cumulative ConnectBlock phase timings (ms) — the reference's
        # nTimeCheck/nTimeConnect/nTimeVerify/nTimeFlush statics
        # (src/validation.cpp:~1950-2080), surfaced via -debug=bench
        self.bench = {
            "check_ms": 0.0, "connect_ms": 0.0, "verify_ms": 0.0,
            "flush_ms": 0.0, "index_ms": 0.0, "blocks": 0,
        }
        # Pipelined IBD (the settle horizon): blocks are speculatively
        # connected — each into its own CoinsCache layer over the settled
        # cache — while their signature batches are still in flight on the
        # device; externalization (coins merge, undo write, index row,
        # tip/connect listeners) happens at settle time, oldest first, and
        # a settle failure drops every speculative layer (full unwind to
        # the pre-block coin set). depth <= 1 = serial engine. The node
        # runtime wires -pipelinedepth here; the Python IBD import loop is
        # the driver (node.py).
        self.pipeline_depth = 1
        # The speculation TREE (ISSUE 9, generalizing the PR 3 linear
        # horizon): block hash -> entry {idx, block, undo, layer, job,
        # scripts, parent, children, branch, t_connect}. Entries whose
        # ``parent`` is None are roots — children of the settled tip,
        # their layers based directly on the settled cache; every other
        # entry's layer stacks on its parent entry's layer. Competing
        # tips are sibling subtrees; the most-work branch settles in
        # order and losing sibling subtrees are dropped un-externalized.
        self._spec: dict[bytes, dict] = {}
        # -specbranches: cap on live leaves — a hostile peer fanning out
        # forks at the tip buys at most this much concurrent validation;
        # extra forks take the serial candidate path (cheap: they are
        # not most-work, so activation leaves them as candidates).
        self.max_branches = 4
        # -spechold: live-path settle grace (seconds). While the oldest
        # root is younger than this, settle_live() holds it speculative
        # so a competing tip arriving inside the window joins the tree
        # instead of forcing a serial reorg. 0 = settle eagerly (the
        # serial engine's externalization latency, default).
        self.spec_hold_s = 0.0
        # degradation ladder state: consecutive-unwind pressure collapses
        # the tree to single-branch (level 1) then serial (level 2) mode
        # rather than thrashing; sustained clean settles re-open it.
        self._unwind_streak = 0
        self._settles_since_unwind = 0
        self._activating = False  # recursion guard (activation <-> settle)
        self._packer = None  # ops/ecdsa_batch.LanePacker, built lazily
        # serving/sigservice.SigService (node wires it): block connects
        # run under its import_priority() so live mempool lanes dispatch
        # on the CPU lane while the block's own batches own the device
        self.sig_service = None
        self._settling = False  # reentrancy guard (flush <-> settle hooks)
        self.pipeline_stats = {
            "settled_blocks": 0, "unwinds": 0, "unwound_blocks": 0,
            "max_depth": 0, "scan_ms": 0.0, "settle_wait_ms": 0.0,
            "commit_ms": 0.0,
            # speculation-tree accounting (ISSUE 9)
            "branch_drops": 0, "dropped_blocks": 0,
            "branches_live_max": 0, "reorgs": 0, "reorg_depth_max": 0,
            "serial_linear_fallbacks": 0, "degraded_connects": 0,
        }
        # BIP30 pre-scan accounting: probes resolved from cache layers vs
        # the store, and whole scans skipped above the last checkpoint
        # (Core's BIP34-era exemption)
        self.bip30_stats = {
            "lookups": 0, "cache_resolved": 0,
            "skipped_scans": 0, "skipped_lookups": 0,
        }
        # settle-horizon stall sentinel (util/devicewatch, observe-only):
        # speculative blocks parked with no settle progress for the quiet
        # period = a wedged device settle. Registration replaces by name
        # (a fresh manager supersedes the old one's closure — the PR 6
        # collector pattern); the node re-registers with -watchdogquiet
        # and unregisters at close. The probe holds only a WEAKREF: a
        # bare manager (library use, tools) has no close path, and a
        # strong closure would pin its whole UTXO cache in the process-
        # global registry for the rest of the process.
        import weakref

        self_ref = weakref.ref(self)
        dw.WATCHDOG.register(
            "pipeline",
            pending_fn=lambda: (
                len(m._spec) if (m := self_ref()) is not None else 0))
        self._init_genesis()

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_genesis(self):
        genesis = self.params.genesis
        gh = genesis.get_hash()
        if self.block_store.get_block(gh) is None:
            self.block_store.put_block(gh, genesis.serialize())
        idx = CBlockIndex(genesis.header, gh, None)
        idx.status = BlockStatus.VALID_SCRIPTS | BlockStatus.HAVE_DATA
        idx.n_tx = len(genesis.vtx)
        idx.chain_tx = idx.n_tx
        self.block_index[gh] = idx
        self._dirty_index.add(idx)
        best = self.coins.best_block()
        if best == b"\x00" * 32:
            # fresh chainstate: connect genesis outputs
            self.chain.set_tip(idx)
            for tx in genesis.vtx:
                add_coins(self.coins, tx, 0)
            self.coins.set_best_block(gh)
        # warm chainstate: the tip is restored by load_block_index(), which
        # the node runtime calls right after construction (LoadBlockIndexDB)

    def load_block_index(self) -> bool:
        """LoadBlockIndexDB (src/validation.cpp): rebuild the in-memory block
        tree, block-file positions, chain tip, and connect candidates from the
        index DB + the coins DB's best-block marker. Returns False when there
        is nothing to load (fresh datadir). Call once, right after __init__."""
        if self.index_db is None:
            return False
        entries = sorted(self.index_db.iterate_index(), key=lambda e: e[2])
        if not entries:
            return False
        max_seq = 0
        for h, header, height, status, n_tx, blkpos, undopos in entries:
            idx = self.block_index.get(h)
            if idx is None:
                prev = self.block_index.get(header.hash_prev_block)
                if prev is None and height != 0:
                    # orphaned index row (ancestor never flushed) — skip; the
                    # block data, if any, is recoverable via -reindex
                    continue
                idx = CBlockIndex(header, h, prev)
                self.block_index[h] = idx
            idx.status = BlockStatus(status)
            idx.n_tx = n_tx
            self._seq = max_seq = max_seq + 1
            idx.sequence_id = max_seq
            if idx.status & BlockStatus.HAVE_DATA:
                base = idx.prev.chain_tx if idx.prev is not None else 0
                if base > 0 or idx.prev is None:
                    idx.chain_tx = base + idx.n_tx
                else:
                    # repopulate mapBlocksUnlinked: data present but an
                    # ancestor's data is missing
                    self._unlinked.setdefault(idx.prev, []).append(idx)
            if blkpos is not None and hasattr(self.block_store, "positions"):
                self.block_store.positions[h] = blkpos
            if undopos is not None and hasattr(self.block_store, "undo_positions"):
                self.block_store.undo_positions[h] = undopos
        best = self.coins.best_block()
        tip = self.block_index.get(best)
        if tip is None:
            raise BlockValidationError(
                "chainstate-corrupt",
                f"best block {hash_to_hex(best)} not in block index (reindex required)",
            )
        self.chain.set_tip(tip)
        for idx in self.block_index.values():
            if not (idx.status & BlockStatus.FAILED_MASK):
                self._try_add_candidate(idx)
            else:
                self._invalid.add(idx)
        log_print("db", "LoadBlockIndexDB: %d entries, tip height %d",
                  len(entries), tip.height)
        return True

    # ------------------------------------------------------------------
    # context-free checks
    # ------------------------------------------------------------------

    def check_block_header(self, header: CBlockHeader, check_pow: bool = True) -> None:
        """CheckBlockHeader: proof of work only (src/validation.cpp)."""
        if check_pow and not check_proof_of_work(
            header.get_hash(), header.bits, self.params.consensus
        ):
            raise BlockValidationError("high-hash", "proof of work failed")

    def check_block(self, block: CBlock, check_pow: bool = True,
                    check_merkle: bool = True) -> None:
        """CheckBlock (src/validation.cpp): header + merkle + tx sanity."""
        self.check_block_header(block.header, check_pow)

        if check_merkle:
            # supervised chooser (ops/dispatch.block_merkle_root): device
            # tree-reduction for large blocks under the merkle circuit
            # breaker, byte-exact CPU reference otherwise/on fallback
            from ..ops.dispatch import block_merkle_root as _merkle

            root, mutated = _merkle(block)
            if root != block.header.hash_merkle_root:
                raise BlockValidationError("bad-txnmrklroot", "hashMerkleRoot mismatch")
            if mutated:
                raise BlockValidationError("bad-txns-duplicate", "duplicate transaction")

        if not block.vtx:
            raise BlockValidationError("bad-blk-length", "block with no transactions")
        if block.size() > self.params.max_block_size:
            raise BlockValidationError("bad-blk-length", "size limits failed")
        if not block.vtx[0].is_coinbase():
            raise BlockValidationError("bad-cb-missing", "first tx is not coinbase")
        for tx in block.vtx[1:]:
            if tx.is_coinbase():
                raise BlockValidationError("bad-cb-multiple", "more than one coinbase")
        for tx in block.vtx:
            try:
                check_transaction(tx)
            except TxValidationError as e:
                raise BlockValidationError(e.reason, f"tx {tx.txid_hex}") from e

    # ------------------------------------------------------------------
    # contextual checks
    # ------------------------------------------------------------------

    def contextual_check_block_header(self, header: CBlockHeader,
                                      prev: CBlockIndex) -> None:
        """ContextualCheckBlockHeader: difficulty, timestamps, checkpoints."""
        expected_bits = get_next_work_required(prev, header.time, self.params.consensus)
        if header.bits != expected_bits:
            raise BlockValidationError("bad-diffbits", "incorrect proof of work")
        if header.time <= prev.get_median_time_past():
            raise BlockValidationError("time-too-old", "block's timestamp is too early")
        if header.time > self.get_time() + MAX_FUTURE_BLOCK_TIME:
            raise BlockValidationError("time-too-new", "block timestamp too far in the future")
        height = prev.height + 1
        cp_hash = self.params.checkpoints.get(height)
        if cp_hash is not None and header.get_hash() != cp_hash:
            raise BlockValidationError("checkpoint-mismatch", f"height {height}")
        # Reject forks below the last checkpoint we have on the active chain —
        # GetLastCheckpoint + the bad-fork-prior-to-checkpoint rule.
        last_cp = self._last_checkpoint_height()
        if height < last_cp:
            raise BlockValidationError(
                "bad-fork-prior-to-checkpoint", f"height {height} < checkpoint {last_cp}"
            )

    def _last_checkpoint_height(self) -> int:
        """Height of the highest checkpoint present on the active chain —
        Checkpoints::GetLastCheckpoint (src/checkpoints.cpp)."""
        for h in sorted(self.params.checkpoints, reverse=True):
            idx = self.chain[h]
            if idx is not None and idx.hash == self.params.checkpoints[h]:
                return h
        return 0

    def test_block_validity(self, block: CBlock) -> None:
        """TestBlockValidity (src/validation.cpp:~3500): full non-PoW
        validation of a tip candidate on a throwaway view — header context
        (nBits/time), block rules, and a scripts-on connect dry-run.
        Raises BlockValidationError. The dry-run itself mutates nothing,
        but with a live speculation tree open it first settles the
        horizon (an externalization: tip listeners may fire) so the
        throwaway view and tip() agree on one coin state."""
        from .coins import CoinsCache

        # the dry-run connects against self.coins (settled) at tip() —
        # with a live tree open those disagree; settle to realign
        self.settle_horizon()
        tip = self.tip()
        self.check_block(block, check_pow=False)
        self.contextual_check_block_header(block.header, tip)
        self.contextual_check_block(block, tip)
        idx = CBlockIndex(block.header, block.get_hash(), tip)
        self.connect_block(block, idx, check_scripts=True,
                           view=CoinsCache(self.coins))

    def contextual_check_block(self, block: CBlock, prev: CBlockIndex) -> None:
        """ContextualCheckBlock: BIP34 height-in-coinbase, tx finality."""
        height = prev.height + 1
        mtp = prev.get_median_time_past()
        for tx in block.vtx:
            if not self._is_final_tx(tx, height, mtp):
                raise BlockValidationError("bad-txns-nonfinal", "non-final transaction")
        if height >= self.params.consensus.bip34_height:
            expect = _script_int(height)
            script_sig = block.vtx[0].vin[0].script_sig
            if script_sig[: len(expect)] != expect:
                raise BlockValidationError("bad-cb-height", "block height mismatch in coinbase")

    _is_final_tx = staticmethod(is_final_tx)

    # ------------------------------------------------------------------
    # header / block acceptance into the tree
    # ------------------------------------------------------------------

    def accept_block_header(self, header: CBlockHeader) -> CBlockIndex:
        """AcceptBlockHeader: check + insert into the block tree."""
        h = header.get_hash()
        existing = self.block_index.get(h)
        if existing is not None:
            if existing.status & BlockStatus.FAILED_MASK:
                raise BlockValidationError("duplicate", "block is marked invalid")
            return existing
        self.check_block_header(header)
        prev = self.block_index.get(header.hash_prev_block)
        if prev is None:
            raise BlockValidationError("prev-blk-not-found", hash_to_hex(header.hash_prev_block))
        if prev.status & BlockStatus.FAILED_MASK:
            raise BlockValidationError("bad-prevblk", "previous block invalid")
        self.contextual_check_block_header(header, prev)
        idx = CBlockIndex(header, h, prev)
        self._seq += 1
        idx.sequence_id = self._seq
        idx.raise_validity(BlockStatus.VALID_TREE)
        self.block_index[h] = idx
        self._dirty_index.add(idx)
        return idx

    def accept_block(self, block: CBlock) -> CBlockIndex:
        """AcceptBlock (src/validation.cpp:~3000): header + full block checks,
        persist to the block store, mark HAVE_DATA, register candidate."""
        idx = self.accept_block_header(block.header)
        if idx.status & BlockStatus.HAVE_DATA:
            return idx  # already have it
        self.check_block(block)
        self.contextual_check_block(block, idx.prev)
        idx.n_tx = len(block.vtx)
        idx.raise_validity(BlockStatus.VALID_TRANSACTIONS)
        idx.status |= BlockStatus.HAVE_DATA
        self.block_store.put_block(idx.hash, block.serialize())
        self._link_chain_tx(idx)
        self._dirty_index.add(idx)
        return idx

    def _link_chain_tx(self, idx: CBlockIndex):
        """ReceivedBlockTransactions (src/validation.cpp): propagate the
        nChainTx analogue down any now-complete subtree; blocks whose
        ancestry still lacks data park in _unlinked until the gap fills."""
        if idx.prev is not None and idx.prev.chain_tx == 0:
            self._unlinked.setdefault(idx.prev, []).append(idx)
            return
        queue = [idx]
        while queue:
            cur = queue.pop()
            base = cur.prev.chain_tx if cur.prev is not None else 0
            cur.chain_tx = base + cur.n_tx
            self._try_add_candidate(cur)
            queue.extend(self._unlinked.pop(cur, ()))

    def _try_add_candidate(self, idx: CBlockIndex):
        tip = self.chain.tip()
        if (
            idx.chain_tx > 0  # whole ancestor path has block data
            and idx.is_valid(BlockStatus.VALID_TRANSACTIONS)
            and (tip is None
                 or self._work_key(idx) > self._work_key(tip))
        ):
            self._candidates.add(idx)

    # ------------------------------------------------------------------
    # connect / disconnect
    # ------------------------------------------------------------------

    def connect_block(self, block: CBlock, idx: CBlockIndex,
                      check_scripts: bool = True,
                      view: Optional[CoinsCache] = None) -> BlockUndo:
        """ConnectBlock (src/validation.cpp:~1700).

        Edits go to `view` when given (dry-runs pass a throwaway layer and
        own it; _connect_tip passes a scratch it flushes itself). With no
        view, edits build on an internal scratch layer that is merged into
        self.coins ONLY on success — a failing connect can never corrupt the
        live cache. Returns undo data.
        """
        merge_on_success = view is None
        if view is None:
            view = CoinsCache(self.coins)
        coins_save, self.coins = self.coins, view
        try:
            undo = self._connect_block_inner(block, idx, check_scripts)
        finally:
            self.coins = coins_save
        if merge_on_success:
            view.flush()
        return undo

    def _connect_block_inner(self, block: CBlock, idx: CBlockIndex,
                             check_scripts: bool,
                             sig_jobs: Optional[list] = None,
                             branch: Optional[str] = None) -> BlockUndo:
        height = idx.height
        consensus = self.params.consensus

        # BIP30: no overwriting of existing unspent coins. Core's BIP34-era
        # exemption: above the last active-chain checkpoint (with BIP34
        # active) duplicate txids are impossible — coinbases commit to
        # their height — so the per-output scan is skipped outright. When
        # the scan does run, each probe resolves from cache layers when an
        # entry (live or tombstone) is resident, and otherwise pays only a
        # store EXISTENCE query — never a Coin fetch/deserialize, and never
        # a read-through entry polluting the -dbcache working set.
        b30 = self.bip30_stats
        last_cp = self._last_checkpoint_height()
        if (last_cp > 0 and height > last_cp
                and height >= consensus.bip34_height):
            b30["skipped_scans"] += 1
            b30["skipped_lookups"] += sum(len(tx.vout) for tx in block.vtx)
        else:
            for tx in block.vtx:
                txid = tx.txid
                for i in range(len(tx.vout)):
                    op = COutPoint(txid, i)
                    b30["lookups"] += 1
                    exists = self.coins.have_coin_cached(op)
                    if exists is None:
                        exists = self.coins.have_coin(op)
                    else:
                        b30["cache_resolved"] += 1
                    if exists:
                        raise BlockValidationError(
                            "bad-txns-BIP30", "tried to overwrite transaction")

        undo = BlockUndo([])
        fees = 0
        spent_per_tx: list[list] = []  # per non-coinbase tx: spent Coins, input order
        for tx in block.vtx:
            if tx.is_coinbase():
                add_coins(self.coins, tx, height)
                continue
            txundo = TxUndo([])
            value_in = 0
            for txin in tx.vin:
                coin = self.coins.spend_coin(txin.prevout)
                if coin is None:
                    raise BlockValidationError(
                        "bad-txns-inputs-missingorspent", f"tx {tx.txid_hex}"
                    )
                if coin.is_coinbase and height - coin.height < consensus.coinbase_maturity:
                    raise BlockValidationError(
                        "bad-txns-premature-spend-of-coinbase",
                        f"{height - coin.height} of {consensus.coinbase_maturity}",
                    )
                value_in += coin.out.value
                txundo.prevouts.append(coin)
            if not money_range(value_in):
                raise BlockValidationError("bad-txns-inputvalues-outofrange")
            value_out = tx.total_output_value()
            if value_in < value_out:
                raise BlockValidationError("bad-txns-in-belowout", f"tx {tx.txid_hex}")
            fee = value_in - value_out
            if not money_range(fee):
                raise BlockValidationError("bad-txns-fee-outofrange")
            fees += fee
            undo.vtxundo.append(txundo)
            spent_per_tx.append(txundo.prevouts)
            add_coins(self.coins, tx, height)

        reward = fees + get_block_subsidy(height, consensus)
        if block.vtx[0].total_output_value() > reward:
            raise BlockValidationError(
                "bad-cb-amount",
                f"coinbase pays too much ({block.vtx[0].total_output_value()} > {reward})",
            )

        if check_scripts and self.script_verifier is not None:
            # Deferred batch verification — the CCheckQueue replacement:
            # one call, one TPU dispatch (SURVEY.md §4.2 graft point).
            # With a sig_jobs sink (the pipelined engine) only the SCAN
            # stage runs here — records ship into the cross-block lane
            # packer and the settle stage happens at the horizon.
            tv = _time.perf_counter()
            scan = getattr(self.script_verifier, "scan", None)
            if sig_jobs is not None and scan is not None:
                sig_jobs.append(
                    scan(block, idx, spent_per_tx, packer=self._sig_packer(),
                         tag=branch)
                )
            else:
                self.script_verifier(block, idx, spent_per_tx)
            self.bench["verify_ms"] += (_time.perf_counter() - tv) * 1e3

        self.coins.set_best_block(idx.hash)
        return undo

    def disconnect_block(self, block: CBlock, idx: CBlockIndex,
                         undo: BlockUndo,
                         view: Optional[CoinsCache] = None) -> None:
        """DisconnectBlock: remove created coins, restore spent ones."""
        if view is not None:
            coins_save, self.coins = self.coins, view
            try:
                return self.disconnect_block(block, idx, undo)
            finally:
                self.coins = coins_save
        if len(undo.vtxundo) != len(block.vtx) - 1:
            raise BlockValidationError("bad-undo", "undo tx count mismatch")
        for tx in reversed(block.vtx):
            txid = tx.txid
            for i in range(len(tx.vout)):
                self.coins.spend_coin(COutPoint(txid, i))
        for tx, txundo in zip(reversed(block.vtx[1:]), reversed(undo.vtxundo)):
            if len(txundo.prevouts) != len(tx.vin):
                raise BlockValidationError("bad-undo", "undo input count mismatch")
            for txin, coin in zip(tx.vin, txundo.prevouts):
                self.coins.add_coin(txin.prevout, coin, overwrite=True)
        self.coins.set_best_block(idx.prev.hash)

    # ------------------------------------------------------------------
    # chain activation (reorg engine)
    # ------------------------------------------------------------------

    def _find_most_work_chain(self) -> Optional[CBlockIndex]:
        """FindMostWorkChain: best candidate not known to be invalid."""
        best = None
        for idx in self._candidates:
            if idx.status & BlockStatus.FAILED_MASK:
                continue
            if best is None or (self._work_key(idx)
                                > self._work_key(best)):
                best = idx
        return best

    def activate_best_chain(self) -> None:
        """ActivateBestChain (src/validation.cpp:~2500): step toward the
        most-work valid chain, disconnecting/connecting as needed. The
        comparison is CBlockIndexWorkComparator's (work, then earlier
        sequence wins) so preciousblock's negative sequence ids can win an
        equal-work tie; a later-received equal-work block still loses."""
        # settle-horizon barrier, enforced HERE and not just at the
        # pipelined entry point: serial activation walks and edits
        # self.coins directly, which is only the settled prefix while
        # speculative layers are open — any caller reaching this with an
        # open horizon (today none can; P2P/RPC start after the import
        # drains it) must first settle or the reorg engine would read a
        # coin set missing the speculative edits. No-op when empty or
        # when called back from within a settle.
        self.settle_horizon()
        activating_save, self._activating = self._activating, True
        try:
            while True:
                tip = self.chain.tip()
                target = self._find_most_work_chain()
                if target is None or (tip is not None and (
                    self._work_key(target) <= self._work_key(tip)
                )):
                    self._prune_candidates()
                    return
                if not self._activate_step(target):
                    # target (or an ancestor) failed validation; loop to
                    # retry with the next-best candidate
                    continue
                self._prune_candidates()
                for cb in self.on_tip_changed:
                    cb(self.chain.tip())
                # loop again: a better candidate may have appeared
        finally:
            self._activating = activating_save

    def _activate_step(self, target: CBlockIndex) -> bool:
        """One ActivateBestChainStep: reorg from current tip to target."""
        fork = self.chain.find_fork(target)
        # disconnect to the fork point
        n_disc = 0
        while self.chain.tip() is not None and self.chain.tip() is not fork:
            if not self._disconnect_tip():
                return False
            n_disc += 1
        self._note_reorg(n_disc, target)
        # connect the path fork -> target
        path = []
        idx = target
        while idx is not fork:
            path.append(idx)
            idx = idx.prev
        for idx in reversed(path):
            if not self._connect_tip(idx):
                return False
        return True

    def _note_reorg(self, depth: int, target: CBlockIndex) -> None:
        """Reorg observability: ``depth`` settled blocks were disconnected
        on the way to ``target`` (0 = plain extension, not a reorg)."""
        if depth <= 0:
            return
        ps = self.pipeline_stats
        ps["reorgs"] += 1
        ps["reorg_depth_max"] = max(ps["reorg_depth_max"], depth)
        _REORGS_C.inc()
        _REORG_DEPTH_H.observe(depth)
        tm.instant("block.reorg", depth=depth,
                   to_height=target.height,
                   to_hash=hash_to_hex(target.hash)[:16])
        log_print("bench", "reorg: %d block(s) disconnected toward %s "
                  "height=%d", depth, hash_to_hex(target.hash)[:16],
                  target.height)

    def script_checks_needed(self, idx: CBlockIndex) -> bool:
        """The fScriptChecks assumevalid gate (src/validation.cpp ConnectBlock):
        skip script verification for ancestors of the assume_valid block,
        provided that block is in our index and carries at least the params'
        minimum chain work — the single biggest reindex accelerator
        (SURVEY.md §6.4)."""
        av = self.params.assume_valid
        if not av:
            return True
        av_idx = self.block_index.get(av)
        if av_idx is None or not av_idx.is_valid(BlockStatus.VALID_TREE):
            return True
        if av_idx.chain_work < self.params.minimum_chain_work:
            return True
        return av_idx.get_ancestor(idx.height) is not idx

    def _connect_tip(self, idx: CBlockIndex) -> bool:
        """ConnectTip: load block, connect, update chain; on failure mark
        the subtree invalid and return False."""
        t0 = _time.perf_counter()
        raw = self.block_store.get_block(idx.hash)
        if raw is None:
            # Should be unreachable (chain_tx gating), but recover rather
            # than assert: drop the candidate and let the activation loop
            # pick the next-best chain.
            self._candidates.discard(idx)
            return False
        block = CBlock.from_bytes(raw)
        t1 = _time.perf_counter()
        check_scripts = self.script_checks_needed(idx)
        scratch = CoinsCache(self.coins)
        try:
            undo = self.connect_block(block, idx, check_scripts=check_scripts,
                                      view=scratch)
        except BlockValidationError:
            self._mark_invalid(idx)
            return False  # scratch layer dropped; earlier edits untouched
        t2 = _time.perf_counter()
        scratch.flush()  # merge into the long-lived cache
        self.block_store.put_undo(idx.hash, undo.serialize())
        idx.status |= BlockStatus.HAVE_UNDO
        idx.raise_validity(
            BlockStatus.VALID_SCRIPTS
            if (self.script_verifier and check_scripts)
            else BlockStatus.VALID_CHAIN
        )
        self._dirty_index.add(idx)
        self.chain.set_tip(idx)
        t3 = _time.perf_counter()
        b = self.bench
        b["check_ms"] += (t1 - t0) * 1e3
        b["connect_ms"] += (t2 - t1) * 1e3
        b["flush_ms"] += (t3 - t2) * 1e3
        b["blocks"] += 1
        log_print(
            "bench",
            "ConnectBlock %s height=%d txs=%d: read %.2fms connect %.2fms "
            "post %.2fms [cum: check %.2fms connect %.2fms flush %.2fms]",
            hash_to_hex(idx.hash)[:16], idx.height, len(block.vtx),
            (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
            b["check_ms"], b["connect_ms"], b["flush_ms"],
        )
        for cb in self.on_block_connected:
            cb(block, idx)
        return True

    def _disconnect_tip(self) -> bool:
        tip = self.chain.tip()
        raw = self.block_store.get_block(tip.hash)
        undo_raw = self.block_store.get_undo(tip.hash)
        assert raw is not None and undo_raw is not None
        block = CBlock.from_bytes(raw)
        scratch = CoinsCache(self.coins)
        self.disconnect_block(block, tip, BlockUndo.from_bytes(undo_raw), view=scratch)
        scratch.flush()
        self._dirty_index.add(tip)
        self.chain.set_tip(tip.prev)
        self._try_add_candidate(tip)  # it may become best again later
        for cb in self.on_block_disconnected:
            cb(block, tip)
        return True

    def _mark_invalid(self, idx: CBlockIndex):
        """InvalidBlockFound: FAILED_VALID on idx, FAILED_CHILD on descendants.
        Uses the O(log n) get_ancestor skip-list per index rather than a
        linear prev-walk (round-1/2 weak-item fix)."""
        idx.status |= BlockStatus.FAILED_VALID
        self._invalid.add(idx)
        self._candidates.discard(idx)
        self._dirty_index.add(idx)
        for other in self.block_index.values():
            if other is idx or other.height <= idx.height:
                continue
            if other.get_ancestor(idx.height) is idx:
                other.status |= BlockStatus.FAILED_CHILD
                self._candidates.discard(other)
                self._dirty_index.add(other)

    def _prune_candidates(self):
        tip = self.chain.tip()
        if tip is None:
            return
        self._candidates = {
            c for c in self._candidates
            if self._work_key(c) > self._work_key(tip)
            and not (c.status & BlockStatus.FAILED_MASK)
        }

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def process_new_block(self, block: CBlock) -> bool:
        """ProcessNewBlock (src/validation.cpp:~3100). Returns True if the
        block was accepted into the tree (not necessarily the active chain).
        Raises BlockValidationError for invalid blocks (callers that need
        the reference's bool-only contract catch it)."""
        with self._import_priority():
            self.accept_block(block)
            self.activate_best_chain()
        return True

    def _import_priority(self):
        """Block-import preemption over the live signature service: while
        a connect is in flight, mempool lanes take the CPU path so the
        block's own batches keep the device (serving/sigservice)."""
        if self.sig_service is not None:
            return self.sig_service.import_priority()
        from contextlib import nullcontext

        return nullcontext()

    # ------------------------------------------------------------------
    # pipelined connect — the IBD settle horizon (overlaps the host scan,
    # the device signature settle, and the chainstate commit)
    # ------------------------------------------------------------------

    def settled_tip(self) -> Optional[CBlockIndex]:
        """The newest block whose signature batch has SETTLED — the only
        tip the outside world may observe (RPC getbestblockhash, P2P
        announcements, index flush). Equals chain.tip() whenever no
        speculative horizon is open."""
        for ent in self._spec.values():
            if ent["parent"] is None:
                return ent["idx"].prev
        return self.chain.tip()

    # -- speculation-tree shape queries ---------------------------------

    @property
    def _horizon(self) -> list[dict]:
        """The WINNING path of the speculation tree, root -> best leaf —
        the linear view PR 3 callers (tests, the watchdog probe, the
        flush barrier) reason about. Read-only by construction."""
        ent = self._best_spec_leaf()
        if ent is None:
            return []
        path = [ent]
        while path[-1]["parent"] is not None:
            path.append(self._spec[path[-1]["parent"]])
        path.reverse()
        return path

    @staticmethod
    def _work_key(idx: CBlockIndex) -> tuple:
        """CBlockIndexWorkComparator's key (work, then earlier-seen)."""
        return (idx.chain_work, -idx.sequence_id)

    def _spec_roots(self) -> list[dict]:
        return [e for e in self._spec.values() if e["parent"] is None]

    def _spec_leaves(self) -> list[dict]:
        return [e for e in self._spec.values() if not e["children"]]

    def _best_spec_leaf(self) -> Optional[dict]:
        """Entry holding the tree-wide most-work tip. chain_work is
        strictly increasing along a branch, so the global max is a leaf."""
        best = None
        for ent in self._spec.values():
            if best is None or (self._work_key(ent["idx"])
                                > self._work_key(best["idx"])):
                best = ent
        return best

    def _subtree(self, ent: dict) -> list[dict]:
        """``ent`` plus every descendant entry, parents-first."""
        out, queue = [], [ent]
        while queue:
            cur = queue.pop(0)
            out.append(cur)
            queue.extend(self._spec[h] for h in cur["children"]
                         if h in self._spec)
        return out

    def _subtree_best_key(self, ent: dict) -> tuple:
        return max(self._work_key(e["idx"]) for e in self._subtree(ent))

    def _winning_root(self) -> Optional[dict]:
        """The root whose subtree holds the most-work leaf — the next
        entry to settle."""
        best, best_key = None, None
        for root in self._spec_roots():
            key = self._subtree_best_key(root)
            if best is None or key > best_key:
                best, best_key = root, key
        return best

    def _settled_anchor(self) -> Optional[CBlockIndex]:
        """The settled tip computed WITHOUT consulting chain.tip() — safe
        mid-mutation (an unwind leaves chain.tip() pointing into the
        just-dropped branch until _retip runs): the tree's root anchor
        when branches are open, else the settled cache's best-block
        marker (the last flushed layer stamps it)."""
        for ent in self._spec.values():
            if ent["parent"] is None:
                return ent["idx"].prev
        idx = self.block_index.get(self.coins.best_block())
        return idx if idx is not None else self.chain.tip()

    def _retip(self) -> None:
        """Point the in-memory chain at the tree-wide best leaf (or the
        settled tip when nothing speculative beats it / the tree is
        empty) and refresh the tree gauges."""
        leaf = self._best_spec_leaf()
        settled = self._settled_anchor()
        if leaf is not None and (
                settled is None
                or self._work_key(leaf["idx"]) > self._work_key(settled)):
            self.chain.set_tip(leaf["idx"])
        elif settled is not None:
            self.chain.set_tip(settled)
        n_leaves = len(self._spec_leaves())
        _BRANCHES_G.set(n_leaves)
        _LAYERS_G.set(len(self._spec))
        ps = self.pipeline_stats
        ps["branches_live_max"] = max(ps["branches_live_max"], n_leaves)

    def _collapse_level(self) -> int:
        """The degradation ladder (0 = full tree, 1 = single branch,
        2 = serial). Driven by consecutive-unwind pressure — a branch
        that keeps failing at settle must not thrash layer churn — and
        by the ecdsa breaker: with the device path distrusted every lane
        goes to the CPU engine anyway, so concurrent branch validation
        only multiplies host work."""
        if self._unwind_streak >= 4:
            return 2
        level = 1 if self._unwind_streak >= 2 else 0
        try:
            from ..ops import dispatch

            if not dispatch.breaker("ecdsa").healthy():
                level = max(level, 1)
        except Exception:  # noqa: BLE001 — observability must not gate
            pass
        return level

    def _sig_packer(self):
        """The session's cross-block lane packer (ops/ecdsa_batch): fresh
        sigcheck records from every in-flight block aggregate into full
        padded device buckets instead of per-block partial dispatches."""
        if self._packer is None:
            from ..ops.ecdsa_batch import LanePacker

            self._packer = LanePacker(
                backend=getattr(self.script_verifier, "backend", "auto"),
                kernel=getattr(self.script_verifier, "kernel", None))
        return self._packer

    def process_new_block_pipelined(self, block: CBlock) -> bool:
        """ProcessNewBlock for the pipelined drivers (node.py import
        loop, P2P block flow). Any extension of the settled tip or of an
        in-tree entry is speculatively connected — UTXO edits into a
        fresh CoinsCache layer stacked per branch, undo retained,
        signature batch left in flight — competing tips validating
        concurrently as sibling subtrees (ISSUE 9). Backpressure settles
        the winning branch oldest-first once the winning path reaches
        pipeline_depth; losing branches drop at settle. Reorg candidates
        route through _activate_best_chain_pipelined (serial undo-based
        disconnects, tree-speculative reconnects); the degradation
        ladder (_collapse_level) narrows the tree to single-branch then
        serial mode under unwind pressure or an unhealthy ecdsa breaker.
        Same raise/return contract as process_new_block."""
        if self.pipeline_depth <= 1:
            return self.process_new_block(block)
        with self._import_priority():
            return self._process_new_block_pipelined_inner(block)

    def _process_new_block_pipelined_inner(self, block: CBlock) -> bool:
        idx = self.accept_block(block)
        if idx.hash in self._spec:
            return True  # already speculative (duplicate delivery)
        level = self._collapse_level()
        if level >= 2:
            # serial collapse: the tree has proven itself unhealthy —
            # drain it and run the reference engine until settles recover.
            # Successful serial activations count toward recovery too:
            # with no pipelined settles happening, nothing else could
            # ever re-open the tree.
            self.pipeline_stats["degraded_connects"] += 1
            tip_before = self.chain.tip()
            self.settle_horizon()
            self.activate_best_chain()
            if (self.chain.tip() is not tip_before
                    and not (idx.status & BlockStatus.FAILED_MASK)):
                self._settles_since_unwind += 1
                if self._settles_since_unwind >= 8:
                    self._unwind_streak = 0
            return True
        # backpressure: bound the WINNING path before connecting another
        # block (competing branches ride along, capped by max_branches)
        while len(self._horizon) >= self.pipeline_depth:
            if not self._settle_oldest():
                break  # unwound — idx's ancestry may now be invalid
        if not (idx.status & BlockStatus.FAILED_MASK):
            if self._speculatable(idx, level):
                if self._connect_tip_speculative(idx, block):
                    return True
                # scan-stage reject: fall through to the serial engine's
                # next-best-candidate retry, like a failed ConnectTip
            elif (idx.prev is self.chain.tip()
                    and self._find_most_work_chain() is idx):
                # invariant TRIPWIRE, not a live code path: by
                # construction _speculatable() accepts every linear
                # most-work extension at every collapse level, so this
                # counter stays 0 — the fork-storm acceptance run
                # asserts that, catching any future _speculatable
                # regression that would quietly re-serialize the fast
                # path
                self.pipeline_stats["serial_linear_fallbacks"] += 1
        # NOT an unconditional settle: a declined non-most-work fork must
        # leave the open tree alone (activation drains the horizon itself
        # exactly when a below-settled-tip reorg needs it)
        self._activate_best_chain_pipelined()
        return True

    def _speculatable(self, idx: CBlockIndex, level: int) -> bool:
        """May ``idx`` enter the speculation tree right now? Its parent
        must be the settled tip (a new root) or an in-tree entry; at
        collapse level >= 1 only a linear extension of the current best
        leaf qualifies; and a connect that would mint a new leaf beyond
        max_branches is declined (the serial candidate path is cheap for
        non-most-work forks)."""
        parent_ent = self._spec.get(idx.prev.hash) if idx.prev else None
        is_root = idx.prev is self.settled_tip()
        if not is_root and parent_ent is None:
            return False
        if level >= 1:
            # single-branch mode: only extend the winning leaf
            best = self._best_spec_leaf()
            if best is None:
                return is_root and not self._spec
            return parent_ent is best
        adds_leaf = is_root or bool(parent_ent["children"])
        if adds_leaf and len(self._spec_leaves()) + (1 if self._spec else 0) \
                > self.max_branches:
            return False
        return True

    def _connect_tip_speculative(self, idx: CBlockIndex,
                                 block: CBlock) -> bool:
        """ConnectTip minus externalization: edits land in a NEW CoinsCache
        layer stacked on the parent entry's layer (or the settled cache
        for a root), the script verifier runs its SCAN stage only, and the
        block's undo write, index row, validity raise, and listeners are
        all withheld until settle. On a scan-stage failure the layer is
        dropped and the block marked invalid — the serial _connect_tip
        verdict, just earlier. Competing tips land as sibling subtrees;
        their deferred records share the cross-block LanePacker, tagged
        with their branch for attribution."""
        t0 = _time.perf_counter()
        check_scripts = self.script_checks_needed(idx)
        parent_ent = self._spec.get(idx.prev.hash) if idx.prev else None
        if parent_ent is None and idx.prev is not self.settled_tip():
            # parent neither the settled tip nor in-tree: basing the
            # layer on self.coins would connect against the WRONG coin
            # state (a backpressure settle inside the activation path
            # loop can advance the settled tip past the fork point mid-
            # connect). Decline — the block is NOT invalid — and let the
            # caller's activation loop recompute fork/target against the
            # moved anchor.
            return False
        base = parent_ent["layer"] if parent_ent is not None else self.coins
        branch = (parent_ent["branch"] if parent_ent is not None
                  else hash_to_hex(idx.hash)[:12])
        layer = CoinsCache(base)
        jobs: list = []
        coins_save, self.coins = self.coins, layer
        # the scan span is the parent of this block's ecdsa.settle spans
        # (the batch captures trace_context() at dispatch) — trace_view
        # stitches scan end -> settle end into the per-block in-flight
        # window and measures the overlap fraction from it
        with tm.span("block.scan", height=idx.height,
                     hash=hash_to_hex(idx.hash)[:16]):
            try:
                undo = self._connect_block_inner(block, idx, check_scripts,
                                                 sig_jobs=jobs,
                                                 branch=branch)
            except BlockValidationError:
                for j in jobs:
                    j.drain()
                self._mark_invalid(idx)
                return False
            finally:
                self.coins = coins_save
        self._spec[idx.hash] = {
            "idx": idx, "block": block, "undo": undo, "layer": layer,
            "job": jobs[0] if jobs else None,
            "scripts": bool(check_scripts and self.script_verifier),
            "parent": parent_ent["idx"].hash if parent_ent else None,
            "children": [], "branch": branch,
            "t_connect": _time.monotonic(),
        }
        if parent_ent is not None:
            parent_ent["children"].append(idx.hash)
        self._retip()
        # prune like the serial engine does after every activation step —
        # without this, every imported block stays a candidate and the
        # per-block _find_most_work_chain scan turns a long linear IBD
        # quadratic (the candidate set must stay ~empty in steady state)
        self._prune_candidates()
        ps = self.pipeline_stats
        ps["max_depth"] = max(ps["max_depth"], len(self._horizon))
        ps["scan_ms"] += (_time.perf_counter() - t0) * 1e3
        _SCAN_H.observe(_time.perf_counter() - t0)
        # one speculative connect = forward progress: a branch stalled at
        # settle then shows pending-with-no-beat and the devicewatch
        # watchdog fires bcp_watchdog_stalled instead of IBD hanging mute
        dw.WATCHDOG.beat("pipeline")
        return True

    def _settle_oldest(self) -> bool:
        """Settle the winning branch's root block: wait for its signature
        batch, then externalize (coins merged into the settled cache,
        undo + index row written, VALID_SCRIPTS raised, connect/tip
        listeners fired) and drop every losing sibling subtree — their
        layers were stacked on the same settled cache the winner just
        flushed into, so once the winner externalizes they can never
        settle (reactivating one later is a real reorg, via undo data).
        Returns False when the batch failed — exactly the failing branch
        is unwound (byte-identical pre-fork coin set by construction)
        and the failing block marked invalid; sibling branches survive
        and the next call settles the new most-work branch."""
        ent = self._winning_root()
        if ent is None:
            return True
        idx = ent["idx"]
        settling_save, self._settling = self._settling, True
        try:
            t0 = _time.perf_counter()
            if ent["job"] is not None:
                try:
                    with tm.span("block.settle", height=idx.height,
                                 hash=hash_to_hex(idx.hash)[:16]):
                        ent["job"].settle()
                except BlockValidationError as e:
                    self._unwind_branch(ent, e)
                    return False
            t1 = _time.perf_counter()
            _SETTLE_H.observe(t1 - t0)
            with tm.span("block.commit", height=idx.height):
                # losing siblings first: their layers read through the
                # settled cache the winner is about to mutate
                for root in self._spec_roots():
                    if root is not ent:
                        self._drop_subtree(root, "lost-work")
                self._spec.pop(idx.hash)
                ent["layer"].flush()  # into the settled cache (self.coins)
                for child_h in ent["children"]:
                    child = self._spec.get(child_h)
                    if child is None:
                        continue
                    # re-base onto the settled cache — the old base is
                    # the (now empty) layer just flushed — and promote
                    # to root: the settled tip advanced onto ``idx``
                    child["layer"].base = self.coins
                    child["parent"] = None
                self.block_store.put_undo(idx.hash, ent["undo"].serialize())
                idx.status |= BlockStatus.HAVE_UNDO
                idx.raise_validity(
                    BlockStatus.VALID_SCRIPTS if ent["scripts"]
                    else BlockStatus.VALID_CHAIN
                )
                self._dirty_index.add(idx)
                ps = self.pipeline_stats
                ps["settled_blocks"] += 1
                ps["settle_wait_ms"] += (t1 - t0) * 1e3
                self._settles_since_unwind += 1
                if self._settles_since_unwind >= 8:
                    # sustained clean settles re-open the tree
                    self._unwind_streak = 0
                self.bench["blocks"] += 1
                self._retip()
                for cb in self.on_block_connected:
                    cb(ent["block"], idx)
                for cb in self.on_tip_changed:
                    cb(idx)
            ps["commit_ms"] += (_time.perf_counter() - t1) * 1e3
            _COMMIT_H.observe(_time.perf_counter() - t1)
            dw.WATCHDOG.beat("pipeline")  # one block settled = progress
            return True
        finally:
            self._settling = settling_save

    def _drop_subtree(self, root: dict, reason: str) -> None:
        """Drop one losing branch: drain its in-flight batches, discard
        its layers, and forget the entries. Nothing was externalized —
        the blocks stay HAVE_DATA candidates in the block index, so a
        later deep reorg can still activate them through the serial
        machinery (undo-based disconnects)."""
        entries = self._subtree(root)
        for ent in entries:
            if ent["job"] is not None:
                ent["job"].drain()
            self._spec.pop(ent["idx"].hash, None)
        for ent in entries:
            self._try_add_candidate(ent["idx"])
        ps = self.pipeline_stats
        ps["branch_drops"] += 1
        ps["dropped_blocks"] += len(entries)
        _BRANCH_DROPS_C.inc()
        lifetime_ms = (_time.monotonic() - root["t_connect"]) * 1e3
        tm.instant("block.branch_drop",
                   branch=root["branch"],
                   height=root["idx"].height,
                   hash=hash_to_hex(root["idx"].hash)[:16],
                   blocks=len(entries), reason=reason,
                   lifetime_ms=round(lifetime_ms, 3))
        log_print(
            "bench",
            "speculative branch dropped (%s): %d block(s) from %s "
            "height=%d, lived %.0f ms",
            reason, len(entries), hash_to_hex(root["idx"].hash)[:16],
            root["idx"].height, lifetime_ms,
        )

    def _unwind_branch(self, root: dict,
                       err: BlockValidationError) -> None:
        """A settle failure at a branch root: drop exactly that branch's
        subtree, drain its in-flight batches, mark the failing block
        invalid, and roll the in-memory tip back to the best surviving
        leaf (or the settled tip). The settled cache was never touched
        by the dropped layers, so the UTXO set is byte-identical to the
        pre-fork state by construction; sibling branches keep their
        layers and stay settleable."""
        failed = root["idx"]
        entries = self._subtree(root)
        for ent in entries:
            if ent["job"] is not None:
                ent["job"].drain()
            self._spec.pop(ent["idx"].hash, None)
        self._mark_invalid(failed)
        # roll the tip back FIRST: the candidate re-seed below compares
        # against chain.tip(), and a dormant fork the dead branch was
        # shadowing must pass that comparison (PR 3 ordering, kept)
        self._retip()
        # the tip ROLLED BACK: candidates pruned while it was ahead may be
        # viable again — re-seed from scratch, the invalidate_block recipe
        for other in self.block_index.values():
            self._try_add_candidate(other)
        ps = self.pipeline_stats
        ps["unwinds"] += 1
        ps["unwound_blocks"] += len(entries)
        self._unwind_streak += 1
        self._settles_since_unwind = 0
        _UNWINDS_C.inc(len(entries))
        # an unwind drains the branch — progress, not a stall
        dw.WATCHDOG.beat("pipeline")
        tm.instant("block.unwind", height=failed.height,
                   hash=hash_to_hex(failed.hash)[:16],
                   branch=root["branch"],
                   dropped=len(entries), reason=err.reason)
        log_print(
            "bench",
            "speculative branch unwound: %d block(s) dropped, "
            "%s invalid (%s)",
            len(entries), hash_to_hex(failed.hash)[:16], err.reason,
        )

    def _drain_spec(self) -> None:
        """Settle/unwind everything speculative WITHOUT the post-unwind
        activation retry — the internal barrier for activation steps
        (which own their candidate loop) and the body of the public
        settle_horizon."""
        while self._spec:
            self._settle_oldest()

    def settle_horizon(self) -> None:
        """Settle every speculative block, winning branch first — the
        barrier before any serial-path activation, reorg, external flush,
        or shutdown. Reentrancy-safe: a connect listener that triggers
        flush() mid-settle does not recurse. Like the serial engine, a
        failing block is marked invalid without raising; surviving
        branches keep settling (each failure drops at least one entry,
        so the loop terminates).

        An unwind can expose a DORMANT better candidate — a fork that
        was declined for speculation while the now-dead branch was
        ahead. Outside an activation (which owns its own candidate
        retry loop) the drain re-runs activation until quiescent, so a
        final-drain unwind converges exactly like the serial engine's
        failure retry would."""
        if self._settling:
            return
        while True:
            unwinds_before = self.pipeline_stats["unwinds"]
            self._drain_spec()
            if (self._activating
                    or self.pipeline_stats["unwinds"] == unwinds_before):
                return
            self._activate_best_chain_pipelined()

    def settle_live(self) -> None:
        """The live-traffic settle policy (P2P driver — per delivered
        block and again each connman tick): settle eagerly, EXCEPT hold
        (a) roots younger than ``spec_hold_s`` — the window in which a
        competing tip can still join the tree instead of forcing a
        serial reorg — and (b) equal-work branch ties, up to 10x the
        window, so a fork race resolves by work (or first-seen once the
        tie goes stale) rather than by arrival interleaving. With
        spec_hold_s == 0 (the default) this is an unconditional drain —
        serial-engine externalization latency. Like settle_horizon, an
        unwind re-runs activation afterwards: a dormant better candidate
        the dead branch was shadowing must not leave a quiet node
        serving a lower-work tip until the next block happens by."""
        if self._settling:
            return
        unwinds_before = self.pipeline_stats["unwinds"]
        while self._spec:
            if self.spec_hold_s > 0:
                now = _time.monotonic()
                win = self._winning_root()
                age = now - win["t_connect"]
                if age < self.spec_hold_s:
                    break
                roots = self._spec_roots()
                if len(roots) > 1:
                    keys = sorted((self._subtree_best_key(r) for r in roots),
                                  reverse=True)
                    tied = keys[0][0] == keys[1][0]  # equal WORK
                    if tied and age < 10 * self.spec_hold_s:
                        break
            self._settle_oldest()
        if (self.pipeline_stats["unwinds"] != unwinds_before
                and not self._activating):
            self._activate_best_chain_pipelined()

    def _activate_best_chain_pipelined(self) -> None:
        """ActivateBestChain with the connect leg running through the
        speculation tree: reorg disconnects stay serial (undo application
        against the settled cache — the horizon is drained first when the
        fork sits below the settled tip), but every path block toward the
        most-work candidate speculatively connects into tree layers, so
        deep reorgs, competing-branch activations, pre-checkpoint eras
        and -loadblock imports all ride the fast path. The horizon may be
        left OPEN on return — the caller's driver (import loop, P2P
        settle_live) owns the settle cadence."""
        activating_save, self._activating = self._activating, True
        try:
            while True:
                tip = self.chain.tip()
                target = self._find_most_work_chain()
                if target is None or (tip is not None and (
                    self._work_key(target) <= self._work_key(tip)
                )):
                    self._prune_candidates()
                    return
                if not self._activate_step_pipelined(target):
                    continue  # target (or ancestor) failed; retry next-best
                # tip/connect listeners fire at SETTLE (the
                # externalization point) — _settle_oldest owns them
                self._prune_candidates()
        finally:
            self._activating = activating_save

    def _activate_step_pipelined(self, target: CBlockIndex) -> bool:
        """One activation step toward ``target`` through the tree. The
        fork point decides the shape: at/above the settled tip nothing
        externalized moves (the new branch just joins the tree and the
        losers fall off at settle); below it, the horizon drains and
        settled blocks disconnect serially (metered as a real reorg)
        before the new path speculatively connects."""
        fork = self.chain.find_fork(target)
        settled = self.settled_tip()
        in_tree = fork is not None and (
            fork is settled or fork.hash in self._spec)
        if not in_tree:
            # direct drain, not settle_horizon: this step runs INSIDE the
            # activation loop, which owns the candidate retry — and the
            # serial disconnects below must never run with open layers
            self._drain_spec()
            # the drain may have unwound and MOVED the tip — the fork
            # point must be recomputed against the post-drain chain or
            # the disconnect walk below could sail past it
            fork = self.chain.find_fork(target)
            n_disc = 0
            while self.chain.tip() is not None \
                    and self.chain.tip() is not fork:
                if not self._disconnect_tip():
                    return False
                n_disc += 1
            self._note_reorg(n_disc, target)
        path = []
        idx = target
        while idx is not fork:
            path.append(idx)
            idx = idx.prev
        for idx in reversed(path):
            if idx.hash in self._spec:
                continue  # already speculative on this branch
            raw = self.block_store.get_block(idx.hash)
            if raw is None:
                self._candidates.discard(idx)
                return False
            block = CBlock.from_bytes(raw)
            while len(self._horizon) >= self.pipeline_depth:
                if not self._settle_oldest():
                    return False  # unwound — ancestry may now be invalid
            if not self._connect_tip_speculative(idx, block):
                return False
        return True

    def pipeline_snapshot(self) -> dict:
        """gettpuinfo's ``pipeline`` section: horizon depth/occupancy,
        per-leg cumulative times, unwind accounting, the cross-block
        lane packer's fill/overlap metrics, and the speculation tree's
        live shape (``tree``)."""
        ps = dict(self.pipeline_stats)
        ps["depth"] = self.pipeline_depth
        ps["in_horizon"] = len(self._horizon)
        packer = self._packer.snapshot() if self._packer is not None else {}
        ps["packer"] = packer
        ps["lane_fill_pct"] = packer.get("lane_fill_pct")
        ps["overlap_fraction"] = packer.get("overlap_fraction", 0.0)
        best = self._best_spec_leaf()
        ps["tree"] = {
            "layers": len(self._spec),
            "roots": len(self._spec_roots()),
            "branches": len(self._spec_leaves()),
            "branches_live_max": self.pipeline_stats["branches_live_max"],
            "max_branches": self.max_branches,
            "spec_hold_s": self.spec_hold_s,
            "best_leaf": (hash_to_hex(best["idx"].hash)[:16]
                          if best is not None else None),
            "branch_drops": self.pipeline_stats["branch_drops"],
            "dropped_blocks": self.pipeline_stats["dropped_blocks"],
            "reorgs": self.pipeline_stats["reorgs"],
            "reorg_depth_max": self.pipeline_stats["reorg_depth_max"],
            "collapse_level": self._collapse_level(),
            "unwind_streak": self._unwind_streak,
            "serial_linear_fallbacks":
                self.pipeline_stats["serial_linear_fallbacks"],
        }
        return ps

    def precious_block(self, idx: CBlockIndex) -> None:
        """PreciousBlock (src/validation.cpp:~2900): treat the block as if
        it had been received before every competitor — a decreasing
        negative sequence id wins the equal-work tie in the comparator."""
        if idx in self.chain:
            return  # already the active chain's block at its height
        self._precious_seq -= 1
        idx.sequence_id = self._precious_seq
        self._dirty_index.add(idx)
        self._try_add_candidate(idx)
        self.activate_best_chain()

    def invalidate_block(self, idx: CBlockIndex) -> None:
        """InvalidateBlock RPC backend: mark invalid and walk the tip back."""
        # settle first: with a live speculation tree open (-spechold) the
        # disconnect walk below needs on-disk undo data, which in-tree
        # blocks don't have yet
        self.settle_horizon()
        self._mark_invalid(idx)
        # disconnect while the invalid block is on the active chain
        while self.chain.tip() is not None and (
            self.chain[idx.height] is idx
        ):
            self._disconnect_tip()
        # re-seed candidates from scratch (conservative, matches semantics)
        for other in self.block_index.values():
            self._try_add_candidate(other)
        self.activate_best_chain()

    def reconsider_block(self, idx: CBlockIndex) -> None:
        """ResetBlockFailureFlags analogue (skip-list descendant test)."""
        for other in list(self.block_index.values()):
            if other is idx or (
                other.height >= idx.height and other.get_ancestor(idx.height) is idx
            ):
                other.status &= ~BlockStatus.FAILED_MASK
                self._invalid.discard(other)
                self._try_add_candidate(other)
                self._dirty_index.add(other)
        self.activate_best_chain()

    def flush(self) -> None:
        """FlushStateToDisk (src/validation.cpp:~1900). Write ordering is the
        crash-safety contract (SURVEY.md §6.3): (1) fsync block/undo files,
        (2) batch-write dirty block-index entries, (3) batch-write the coins
        cache + best-block marker in one transaction. A crash between (2) and
        (3) leaves index entries ahead of the chainstate; on restart those
        blocks are re-activated from their on-disk data."""
        # settle-horizon barrier: nothing speculative may reach disk. The
        # coins cache only ever holds settled edits (speculative blocks
        # live in their own layers), so this is about completeness — a
        # flush called mid-settle (via a connect listener) skips the
        # barrier and persists the settled prefix, which is always safe.
        self.settle_horizon()
        t0 = _time.perf_counter()
        self.block_store.flush()
        self.flush_index()
        self.coins.flush()
        self.bench["index_ms"] += (_time.perf_counter() - t0) * 1e3

    def flush_index(self) -> None:
        """Step (2) of the flush contract alone: batch-write dirty block
        index entries. The native fast-import path orders its own coins
        batch after this (node.py _fast_flush). Rows for blocks still
        inside the settle horizon are withheld — an index flush is a tip
        externalization, and nothing past the horizon is externalized
        until its signature batch settles (they re-dirty at settle)."""
        if self.index_db is not None and self._dirty_index:
            # hold EVERY tree entry, not just the winning path — no
            # speculative block's row may externalize pre-settle
            hold = {ent["idx"] for ent in self._spec.values()}
            flushable = [idx for idx in self._dirty_index
                         if idx not in hold]
            positions = getattr(self.block_store, "positions", {})
            undo_positions = getattr(self.block_store, "undo_positions", {})
            entries = [
                (
                    idx.hash,
                    idx.header.serialize(),
                    idx.height,
                    int(idx.status),
                    idx.n_tx,
                    positions.get(idx.hash),
                    undo_positions.get(idx.hash),
                )
                for idx in flushable
            ]
            if entries:
                self.index_db.put_index_batch(entries)
            self._dirty_index.difference_update(flushable)

    # -- queries used by RPC / mining --

    def tip(self) -> Optional[CBlockIndex]:
        return self.chain.tip()

    def get_block(self, block_hash: bytes) -> Optional[CBlock]:
        raw = self.block_store.get_block(block_hash)
        return CBlock.from_bytes(raw) if raw is not None else None


# BIP34 height encoding = CScript() << nHeight. Delegates to the script
# layer's script_int, which emits OP_1..OP_16/OP_0 single-byte opcodes for
# small values exactly as the reference's CScript operator<< does — a raw
# pushdata for 1..16 would make early regtest coinbases (bip34_height=0)
# incompatible with reference nodes.
_script_int = script_int
