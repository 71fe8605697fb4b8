"""Per-block script verification — the ConnectBlock sigcheck graft point.

Reference: src/validation.cpp:~1250 (CScriptCheck::operator()), :~1300
(CheckInputs), and the CCheckQueue fan-out in ConnectBlock (:~1700,
control.Add/Wait). The thread-pool barrier becomes: run the (cheap,
branchy) script interpreter on host with a DeferringSignatureChecker,
accumulate every OP_CHECKSIG into SigCheckRecords, then settle the whole
block in ONE ops/ecdsa_batch dispatch (SURVEY.md §4.2 graft point).
Failure attribution maps the failing lane back to (tx, input).

Sigcache-verified records are skipped before packing (sigcache.cpp:~70
semantics); fresh records are inserted after a successful batch.
"""

from __future__ import annotations

from typing import Optional

from ..consensus.params import ChainParams
from ..ops import ecdsa_batch
from ..crypto.hashes import hash160
from ..util import telemetry as tm
from ..script.interpreter import (
    SCRIPT_ENABLE_SIGHASH_FORKID,
    SCRIPT_VERIFY_CLEANSTACK,
    SCRIPT_VERIFY_MINIMALDATA,
    SCRIPT_VERIFY_NONE,
    SCRIPT_VERIFY_P2SH,
    SCRIPT_VERIFY_SIGPUSHONLY,
    SCRIPT_VERIFY_STRICTENC,
    SCRIPT_VERIFY_CHECKLOCKTIMEVERIFY,
    SCRIPT_VERIFY_CHECKSEQUENCEVERIFY,
    SCRIPT_VERIFY_DERSIG,
    SCRIPT_VERIFY_LOW_S,
    SCRIPT_VERIFY_NULLDUMMY,
    SCRIPT_VERIFY_NULLFAIL,
    DeferringSignatureChecker,
    ScriptError,
    SigCheckRecord,
    TransactionSignatureChecker,
    VerifyScript,
    check_pubkey_encoding,
    check_signature_encoding,
)
from ..script.sighash import SighashCache
from .sigcache import SignatureCache

# flags whose semantics the P2PKH fast path does not model — any of them
# present forces the generic interpreter (block consensus flags never set
# these; they are policy/test-only)
_FAST_PATH_EXCLUDES = (
    SCRIPT_VERIFY_MINIMALDATA
    | SCRIPT_VERIFY_CLEANSTACK
    | SCRIPT_VERIFY_SIGPUSHONLY
)


def _p2pkh_template(script_sig: bytes, spk: bytes):
    """Detect the standard P2PKH spend shape — the overwhelmingly dominant
    input form during a reindex. Returns (sig, pubkey) or None (anything
    unusual falls back to the generic interpreter).

    spk must be exactly OP_DUP OP_HASH160 <20> OP_EQUALVERIFY OP_CHECKSIG;
    scriptSig exactly two direct pushes (0x01-0x4b length opcodes, or OP_0
    for an empty item) with no trailing bytes."""
    if (len(spk) != 25 or spk[0] != 0x76 or spk[1] != 0xA9 or spk[2] != 20
            or spk[23] != 0x88 or spk[24] != 0xAC):
        return None
    ss = script_sig

    def read_push(pos: int):
        if pos >= len(ss):
            return None
        op = ss[pos]
        if op == 0:
            return b"", pos + 1
        if 1 <= op <= 75:
            end = pos + 1 + op
            if end > len(ss):
                return None
            return ss[pos + 1:end], end
        return None

    got = read_push(0)
    if got is None:
        return None
    sig, pos = got
    got = read_push(pos)
    if got is None:
        return None
    pub, pos = got
    if pos != len(ss):
        return None
    return sig, pub


def _p2pkh_fast_verify(sig: bytes, pub: bytes, spk: bytes, flags: int,
                       checker) -> None:
    """The exact EvalScript outcome for the P2PKH template without the
    generic opcode machinery: DUP/HASH160/EQUALVERIFY collapse to one
    hash160 compare, then the OP_CHECKSIG tail verbatim (same helper
    functions, same error codes, same NULLFAIL/final-truthiness rules as
    interpreter.py:~653). Raises ScriptError exactly where the generic
    path would; returns on success."""
    if hash160(pub) != spk[3:23]:
        raise ScriptError("equalverify")
    check_signature_encoding(sig, flags)
    check_pubkey_encoding(pub, flags)
    ok = checker.check_sig(sig, pub, spk, flags)
    if not ok:
        if (flags & SCRIPT_VERIFY_NULLFAIL) and sig:
            raise ScriptError("sig-nullfail")
        raise ScriptError("eval-false")


def block_script_flags(height: int, block_time: int,
                       params: ChainParams) -> int:
    """Consensus flags for a block at (height, time) — the reference
    derives these era-by-era in ConnectBlock (validation.cpp:~1700):
    P2SH by the BIP16 switch TIME, strict DER at BIP66, CLTV at BIP65,
    CSV at its height, and the fork's UAHF bundle [fork-delta, hedged].
    Historical blocks MUST get historical flags — applying today's
    STRICTENC to 2011 blocks (hybrid pubkeys, loose DER) would reject
    the real chain during reindex."""
    flags = SCRIPT_VERIFY_NONE
    c = params.consensus
    if block_time >= c.bip16_time:
        flags |= SCRIPT_VERIFY_P2SH
    if c.bip66_height >= 0 and height >= c.bip66_height:
        flags |= SCRIPT_VERIFY_DERSIG
    if c.bip65_height >= 0 and height >= c.bip65_height:
        flags |= SCRIPT_VERIFY_CHECKLOCKTIMEVERIFY
    if c.csv_height >= 0 and height >= c.csv_height:
        flags |= SCRIPT_VERIFY_CHECKSEQUENCEVERIFY
    if c.uahf_height >= 0 and height >= c.uahf_height:
        # post-fork: replay-protected sighash, strict encodings, and the
        # batch-soundness pair (NULLFAIL enables sig deferral)
        flags |= (
            SCRIPT_ENABLE_SIGHASH_FORKID
            | SCRIPT_VERIFY_STRICTENC
            | SCRIPT_VERIFY_NULLFAIL
            | SCRIPT_VERIFY_LOW_S
            | SCRIPT_VERIFY_NULLDUMMY
        )
    return flags


class _InlineCountingChecker(TransactionSignatureChecker):
    """Host-side inline sigcheck (pre-NULLFAIL eras) with BatchStats
    metering, so gettpuinfo can report how many sigops bypassed the TPU."""

    def check_sig(self, sig, pubkey, script_code, flags, defer_ok=True):
        ecdsa_batch.STATS.inline_legacy_sigs += 1
        return super().check_sig(sig, pubkey, script_code, flags, defer_ok)


class BlockSigJob:
    """The settle-stage handle for one block's deferred signature checks
    (the pipelined IBD engine's unit of in-flight work, ISSUE 4).

    Produced by BlockScriptVerifier.scan(); carries the block's deferred
    SigCheckRecords, their (tx, input) attribution, and the in-flight
    dispatches (BatchHandles on the serial path, SigBatchFutures when a
    cross-block LanePacker aggregated the lanes). settle() blocks until
    every dispatch reports, raises BlockValidationError with (tx, input)
    attribution on the first bad lane, and inserts the fresh sigcache
    keys only on full success — identical verdict semantics to the old
    synchronous __call__."""

    __slots__ = ("verifier", "block", "records", "rec_attr", "pending",
                 "settled")

    def __init__(self, verifier, block):
        self.verifier = verifier
        self.block = block
        self.records: list[SigCheckRecord] = []
        self.rec_attr: list[tuple[int, int]] = []  # (tx_index, input_index)
        # in-flight chunks: (record_indices, sigcache_keys, handle/future)
        self.pending: list[tuple[list[int], list, object]] = []
        self.settled = False

    def settle(self) -> None:
        """Block until every in-flight chunk reports; raise on failure."""
        from .chainstate import BlockValidationError

        if self.settled:
            return
        try:
            while self.pending:
                fresh, keys, handle = self.pending.pop(0)
                try:
                    ok = handle.result()
                except (KeyboardInterrupt, SystemExit,
                        NameError, AttributeError, UnboundLocalError,
                        ecdsa_batch.KernelUnavailable):
                    raise  # programming errors, missing kernel surface
                except Exception:
                    # settle-time failure the handle could not self-heal:
                    # the verdict is a fresh forced-CPU verification of
                    # this chunk's records — never a cached phantom
                    ecdsa_batch.STATS.fault_fallback_sigs += len(fresh)
                    ok = ecdsa_batch.dispatch_batch(
                        [self.records[k] for k in fresh], backend="cpu"
                    ).result()
                for lane, k in enumerate(fresh):
                    if not ok[lane]:
                        t, i = self.rec_attr[k]
                        tx = self.block.vtx[t]
                        raise BlockValidationError(
                            "blk-bad-inputs",
                            "signature verification failed "
                            f"tx {tx.txid_hex} input {i}",
                        )
                for key in keys:
                    self.verifier.sigcache.add(key)
        finally:
            if self.pending:
                self.drain()
            self.settled = True

    def drain(self) -> None:
        """Abort-path settle: materialize every remaining handle so
        STATS.in_flight (and a breaker half-open probe riding one of them)
        never strands; verdicts are ignored."""
        while self.pending:
            _fresh, _keys, handle = self.pending.pop(0)
            drain = getattr(handle, "drain", None)  # SigBatchFuture: also
            try:                                    # discards parked lanes
                drain() if drain is not None else handle.result()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # noqa: BLE001 — abort-path drain
                pass
        self.settled = True


class BlockScriptVerifier:
    """The ChainstateManager ``script_verifier`` hook (chainstate.py).

    Call contract: (block, idx, spent_per_tx) — spent_per_tx[i] is the
    list of spent Coins for block.vtx[i+1]'s inputs, input order. Raises
    BlockValidationError (via chainstate's exception type) on any failure.

    Pipelined callers split the call into scan() (host script
    interpretation, sigcache probe, dispatch/enqueue) and
    BlockSigJob.settle() (device settlement) so the settle horizon can
    keep connecting blocks while earlier batches are in flight.
    """

    def __init__(self, params: ChainParams, backend: str = "auto",
                 sigcache: Optional[SignatureCache] = None,
                 chunk: int = 4094, kernel: Optional[str] = None):
        self.params = params
        self.backend = backend
        # -ecdsakernel wiring (no semantic change — the dispatch layer owns
        # kernel selection/fallback; None defers to the process default)
        self.kernel = kernel
        self.sigcache = sigcache if sigcache is not None else SignatureCache()
        # P3 pipeline overlap (SURVEY.md §3.2): once this many deferred
        # records accumulate, dispatch them to the chip WITHOUT waiting and
        # keep interpreting the remaining transactions — host script work
        # and device ECDSA verify run concurrently (JAX async dispatch as
        # the CCheckQueue worker pool). Settlement at the end preserves the
        # all-or-nothing block verdict and failure attribution.
        # bucket-2 sizing: the supervised dispatch appends 2 known-answer
        # lanes per batch (ops/ecdsa_batch), so an exact-pow2 chunk would
        # spill into the next (1.5x) compiled bucket every time.
        self.chunk = chunk

    def __call__(self, block, idx, spent_per_tx) -> None:
        # serial engine: scan+settle back to back — spanned here so the
        # trace still shows the two legs (the pipelined engine's spans
        # live in chainstate, around the speculative connect / horizon
        # settle, and do not pass through __call__)
        with tm.span("block.scan", height=idx.height):
            job = self.scan(block, idx, spent_per_tx)
        with tm.span("block.settle", height=idx.height):
            job.settle()

    def scan(self, block, idx, spent_per_tx, packer=None,
             tag=None) -> BlockSigJob:
        """The SCAN stage: host script interpretation over every input,
        deferring OP_CHECKSIG into SigCheckRecords, probing the sigcache,
        and shipping fresh records — to ecdsa_batch.dispatch_batch chunks
        directly (serial path), or into the shared cross-block ``packer``
        (pipelined path), which banks them for full-bucket dispatches and
        hands back per-block futures. ``tag`` names the speculation-tree
        branch the block rides (packer lane attribution — competing
        branches share device buckets and the per-branch lane split is
        the observability for that). Raises BlockValidationError on any
        script failure; signature verdicts arrive at job.settle()."""
        from .chainstate import BlockValidationError

        flags = block_script_flags(
            idx.height, block.header.time, self.params
        )
        defer = bool(flags & SCRIPT_VERIFY_NULLFAIL)

        job = BlockSigJob(self, block)
        records = job.records
        rec_attr = job.rec_attr
        dispatched = 0

        def dispatch_from(start: int) -> int:
            """Sigcache-probe records[start:] and enqueue the fresh ones.

            The dispatch layer (ops/ecdsa_batch + ops/dispatch) owns the
            breaker/fault policy and falls back to the CPU engine
            internally; the extra try here is the last line of defense —
            if the supervision layer ITSELF raises, the batch must not be
            silently dropped: the verdict comes from a fresh forced-CPU
            verification, metered as a fault fallback."""
            keys = [
                SignatureCache.entry_key(r.msg_hash, r.r, r.s, r.pubkey,
                                         r.algo)
                for r in records[start:]
            ]
            fresh = [
                start + j for j, key in enumerate(keys)
                if not self.sigcache.contains(key)
            ]
            ecdsa_batch.STATS.sigcache_hits += (
                len(records) - start - len(fresh)
            )
            if fresh:
                batch = [records[k] for k in fresh]
                if packer is not None:
                    handle = packer.add(batch, tag=tag)
                else:
                    try:
                        handle = ecdsa_batch.dispatch_batch(
                            batch, backend=self.backend, kernel=self.kernel
                        )
                    except (KeyboardInterrupt, SystemExit,
                            NameError, AttributeError, UnboundLocalError,
                            ecdsa_batch.KernelUnavailable):
                        raise  # programming errors, missing kernel surface
                    except Exception:
                        ecdsa_batch.STATS.fault_fallback_sigs += len(batch)
                        handle = ecdsa_batch.dispatch_batch(batch,
                                                            backend="cpu")
                job.pending.append(
                    (fresh, [keys[k - start] for k in fresh], handle)
                )
            return len(records)

        assert len(spent_per_tx) == len(block.vtx) - 1, "spent coins mismatch"
        try:
            for t, (tx, spent) in enumerate(
                zip(block.vtx[1:], spent_per_tx), start=1
            ):
                cache = SighashCache(tx)
                for i, (txin, coin) in enumerate(zip(tx.vin, spent)):
                    if defer:
                        n_before = len(records)
                        checker = DeferringSignatureChecker(
                            tx, i, coin.out.value, records, cache
                        )
                    else:
                        # pre-NULLFAIL blocks: deferral unsound, verify inline
                        checker = _InlineCountingChecker(
                            tx, i, coin.out.value, cache
                        )
                    fast = (
                        _p2pkh_template(txin.script_sig,
                                        coin.out.script_pubkey)
                        if not flags & _FAST_PATH_EXCLUDES else None
                    )
                    try:
                        if fast is not None:
                            ecdsa_batch.STATS.p2pkh_fast_path += 1
                            _p2pkh_fast_verify(
                                fast[0], fast[1], coin.out.script_pubkey,
                                flags, checker
                            )
                        else:
                            VerifyScript(
                                txin.script_sig, coin.out.script_pubkey,
                                flags, checker
                            )
                    except ScriptError as e:
                        raise BlockValidationError(
                            "blk-bad-inputs",
                            f"script failure ({e.code}) "
                            f"tx {tx.txid_hex} input {i}",
                        ) from e
                    if defer:
                        rec_attr.extend(
                            (t, i) for _ in range(len(records) - n_before)
                        )
                # overlap point: enough records banked -> ship a chunk now
                if len(records) - dispatched >= self.chunk:
                    dispatched = dispatch_from(dispatched)

            if dispatched < len(records):
                dispatch_from(dispatched)
        except BaseException:
            # a script failure aborts the block mid-scan: drain the handles
            # already in flight so STATS.in_flight doesn't leak phantom
            # dispatches into gettpuinfo
            job.drain()
            raise
        return job
