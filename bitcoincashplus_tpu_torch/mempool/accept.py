"""AcceptToMemoryPool — transaction admission.

Reference: src/validation.cpp:~400 (AcceptToMemoryPoolWorker): context-free
checks, standardness policy, finality at next-block height/MTP, conflict
rejection (no in-pool replacement in this lineage), coin lookup through a
mempool-backed view (CCoinsViewMemPool), maturity, fee floor, ancestor
limits, then script verification with STANDARD flags through the signature
cache so ConnectBlock later skips the same signatures.

Script verification reuses the deferral machinery (DeferringSignatureChecker
→ ecdsa_batch) so verified (sighash, r, s, pubkey) tuples land in the shared
SignatureCache — the reference achieves the same via CachingTransactionSignatureChecker.
"""

from __future__ import annotations

import time as _time
from typing import Optional

from ..consensus.tx import CTransaction
from ..consensus.tx_check import TxValidationError, check_transaction, is_final_tx
from ..ops import ecdsa_batch
from ..util import telemetry as tm
from ..script.interpreter import (
    SCRIPT_ENABLE_SIGHASH_FORKID,
    STANDARD_SCRIPT_VERIFY_FLAGS,
    DeferringSignatureChecker,
    ScriptError,
    SigCheckRecord,
    VerifyScript,
)
from ..script.script import count_sigops
from ..script.sighash import SighashCache
from ..validation.coins import Coin
from ..validation.sigcache import SignatureCache
from .mempool import CTxMemPool, MempoolEntry, MempoolError
from .policy import (
    are_inputs_standard,
    get_min_relay_fee,
    is_standard_tx,
)

# MEMPOOL_HEIGHT (src/txmempool.h): marker height for coins created by
# in-pool (unconfirmed) parents.
MEMPOOL_HEIGHT = 0x7FFFFFFF

# MAX_STANDARD_TX_SIGOPS (policy.h): 1/5 of the block sigop limit.
MAX_STANDARD_TX_SIGOPS = 4000

# -- telemetry (util/telemetry): the serving path's p50/p99 accept
# latency (ROADMAP "always-on signature service" ask) — one observation
# per AcceptToMemoryPool call, labeled by outcome. Sub-millisecond
# buckets matter here (a cache-hit accept is ~100 µs), so the default
# latency ladder's low end is kept.
_ACCEPT_H = tm.histogram(
    "bcp_mempool_accept_seconds",
    "AcceptToMemoryPool wall-clock per transaction",
    labels=("result",))
_ACCEPT_REJECTS = tm.counter(
    "bcp_mempool_reject_total",
    "Transactions rejected at mempool admission")
# Per-stage breakdown of a successful accept (ISSUE 20): "context" is
# everything up to and including the ancestor-limit check (policy,
# finality, coin lookup, fee floor), "scripts" the signature/script leg,
# "commit" the pool mutation (add_unchecked + trim_to_size). Under a
# flood the interesting question is WHICH stage the p99 lives in —
# admission CPU vs script verify vs eviction pressure.
_STAGE_H = tm.histogram(
    "bcp_mempool_accept_stage_seconds",
    "AcceptToMemoryPool per-stage wall-clock",
    labels=("stage",))


class _StaleContext(Exception):
    """The validation context moved while cs_main was released for the
    SigService verdict wait (tip advanced, or an in-pool parent vanished)
    — the whole acceptance re-runs from scratch (accept_to_memory_pool's
    retry loop; the final attempt is synchronous and cannot go stale)."""


def accept_latency_quantiles() -> dict:
    """gettpuinfo's serving-path latency view: p50/p90/p99 (ms) of
    ACCEPTED transactions, plus accept/reject tallies."""
    acc = _ACCEPT_H.labels(result="accepted")
    rej = _ACCEPT_H.labels(result="rejected")
    out = {f"{k}_ms": round(v * 1e3, 3)
           for k, v in acc.quantiles((0.5, 0.9, 0.99)).items()}
    out["accepted"] = acc.count
    out["rejected"] = rej.count
    return out


def accept_stage_quantiles() -> dict:
    """gettpuinfo.mempool's stage view: p50/p99 (ms) per accept stage."""
    out = {}
    for stage in ("context", "scripts", "commit"):
        h = _STAGE_H.labels(stage=stage)
        out[stage] = {f"{k}_ms": round(v * 1e3, 3)
                      for k, v in h.quantiles((0.5, 0.99)).items()}
        out[stage]["count"] = h.count
    return out


def standard_script_flags(params, height: int) -> int:
    """STANDARD_SCRIPT_VERIFY_FLAGS + the fork's replay-protection flag once
    UAHF is active at the next block height [fork-delta, hedged]."""
    flags = STANDARD_SCRIPT_VERIFY_FLAGS
    uahf = params.consensus.uahf_height
    if uahf >= 0 and height >= uahf:
        flags |= SCRIPT_ENABLE_SIGHASH_FORKID
    return flags


def _tx_sigops(tx: CTransaction, spent_coins: list[Coin]) -> int:
    """GetTransactionSigOpCount: legacy count over scriptSigs + outputs,
    plus accurate P2SH redeem-script sigops."""
    n = sum(count_sigops(txin.script_sig) for txin in tx.vin)
    n += sum(count_sigops(out.script_pubkey) for out in tx.vout)
    from ..script.script import get_script_ops, is_p2sh

    for txin, coin in zip(tx.vin, spent_coins):
        if is_p2sh(coin.out.script_pubkey):
            redeem = b""
            try:
                for _op, data, _ in get_script_ops(txin.script_sig):
                    redeem = data or b""
            except Exception:
                continue
            n += count_sigops(redeem, accurate=True)
    return n


def verify_tx_scripts(
    tx: CTransaction,
    spent_coins: list[Coin],
    flags: int,
    sigcache: Optional[SignatureCache] = None,
    backend: str = "cpu",
    sig_service=None,
    wait_ctx=None,
) -> None:
    """CheckInputs (src/validation.cpp:~1300) for a single transaction:
    run the interpreter per input, settle deferred sigchecks in one batch,
    insert fresh successes into the sigcache. Raises MempoolError.

    With a ``sig_service`` (serving/sigservice.SigService) the deferred
    records are enqueued into the shared micro-batching lanes and the
    per-tx future is awaited — inside ``wait_ctx()`` when supplied, so
    the caller's cs_main hold can be released while the verdict is in
    flight (concurrent accepts then share one device bucket). The
    service populates the sigcache at settle; verdicts are identical to
    the synchronous path by construction (same records, same engines)."""
    records: list[SigCheckRecord] = []
    cache = SighashCache(tx)
    for i, (txin, coin) in enumerate(zip(tx.vin, spent_coins)):
        checker = DeferringSignatureChecker(
            tx, i, coin.out.value, records, cache
        )
        try:
            VerifyScript(txin.script_sig, coin.out.script_pubkey, flags, checker)
        except ScriptError as e:
            raise MempoolError(
                "mandatory-script-verify-flag-failed",
                f"{e.code} input {i}",
            ) from e
    if not records:
        return
    keys = [
        SignatureCache.entry_key(r.msg_hash, r.r, r.s, r.pubkey, r.algo)
        for r in records
    ]
    if sig_service is not None:
        fut = sig_service.submit(records, keys)
        if wait_ctx is not None:
            with wait_ctx():
                ok = fut.result()
        else:
            ok = fut.result()
        for k, good in enumerate(ok):
            if not good:
                raise MempoolError(
                    "mandatory-script-verify-flag-failed",
                    f"signature verification failed input "
                    f"{records[k].in_idx}",
                )
        return  # sigcache populated by the service at settle
    if sigcache is not None:
        fresh = [k for k, key in enumerate(keys) if not sigcache.contains(key)]
    else:
        fresh = list(range(len(records)))
    if fresh:
        ok = ecdsa_batch.verify_batch(
            [records[k] for k in fresh], backend=backend
        )
        for lane, k in enumerate(fresh):
            if not ok[lane]:
                raise MempoolError(
                    "mandatory-script-verify-flag-failed",
                    f"signature verification failed input {records[k].in_idx}",
                )
        if sigcache is not None:
            for k in fresh:
                sigcache.add(keys[k])


def accept_to_memory_pool(
    pool: CTxMemPool,
    chainstate,
    tx: CTransaction,
    sigcache: Optional[SignatureCache] = None,
    require_standard: Optional[bool] = None,
    min_fee_rate: int = 1000,
    backend: str = "cpu",
    now: Optional[int] = None,
    ancestor_limits: Optional[dict] = None,
    sig_service=None,
    wait_ctx=None,
) -> MempoolEntry:
    """AcceptToMemoryPool (src/validation.cpp:~400). Returns the entry on
    success; raises MempoolError with the reference's reject reason.
    Per-tx wall-clock lands in the bcp_mempool_accept_seconds histogram
    (p50/p99 via gettpuinfo.telemetry.accept_latency).

    ``sig_service``/``wait_ctx`` route the signature verdict through the
    micro-batching SigService with the caller's lock released during the
    wait; a context change in that window (tip moved, in-pool parent
    evicted) raises _StaleContext internally and the acceptance re-runs —
    the FINAL attempt synchronously, which cannot go stale, so the
    verdict always lands and is identical to the service-off path."""
    t0 = _time.monotonic()
    with tm.span("mempool.accept", txid=tx.txid_hex):
        try:
            # serviced attempts first; a last synchronous attempt bounds
            # the retry loop (no unlock window => no staleness possible)
            for svc in (sig_service, sig_service, None):
                try:
                    entry = _accept_to_memory_pool_inner(
                        pool, chainstate, tx, sigcache, require_standard,
                        min_fee_rate, backend, now, ancestor_limits,
                        sig_service=svc, wait_ctx=wait_ctx)
                    break
                except _StaleContext:
                    continue
        except MempoolError:
            _ACCEPT_H.labels(result="rejected").observe(
                _time.monotonic() - t0)
            _ACCEPT_REJECTS.inc()
            raise
    _ACCEPT_H.labels(result="accepted").observe(_time.monotonic() - t0)
    return entry


def _accept_to_memory_pool_inner(
    pool: CTxMemPool,
    chainstate,
    tx: CTransaction,
    sigcache: Optional[SignatureCache],
    require_standard: Optional[bool],
    min_fee_rate: int,
    backend: str,
    now: Optional[int],
    ancestor_limits: Optional[dict],
    sig_service=None,
    wait_ctx=None,
) -> MempoolEntry:
    t_ctx = _time.monotonic()
    params = chainstate.params
    if require_standard is None:
        require_standard = params.require_standard
    tip = chainstate.tip()
    height = tip.height + 1  # validation happens at next-block height
    mtp = tip.get_median_time_past()

    try:
        check_transaction(tx)
    except TxValidationError as e:
        raise MempoolError(e.reason, e.debug) from e
    if tx.is_coinbase():
        raise MempoolError("coinbase")
    if require_standard:
        ok, reason = is_standard_tx(tx)
        if not ok:
            raise MempoolError(reason)
    if not is_final_tx(tx, height, mtp):
        raise MempoolError("non-final")

    txid = tx.txid
    if txid in pool:
        raise MempoolError("txn-already-in-mempool")
    for txin in tx.vin:
        spender = pool.get_spender(txin.prevout)
        if spender is not None:
            raise MempoolError("txn-mempool-conflict")

    # coin lookup: chainstate view backed by in-pool outputs (CCoinsViewMemPool)
    spent_coins: list[Coin] = []
    spends_coinbase = False
    for txin in tx.vin:
        coin = chainstate.coins.get_coin(txin.prevout)
        if coin is None:
            out = pool.get_output(txin.prevout)
            if out is not None:
                coin = Coin(out, MEMPOOL_HEIGHT, False)
        if coin is None:
            # distinguish already-spent-in-chain from never-seen the way the
            # reference's missing-inputs path does (both are non-fatal there;
            # we surface one reason)
            raise MempoolError("missing-inputs", f"{txin.prevout!r}")
        if coin.is_coinbase:
            spends_coinbase = True
            if height - coin.height < params.consensus.coinbase_maturity:
                raise MempoolError(
                    "bad-txns-premature-spend-of-coinbase",
                    f"{height - coin.height} of {params.consensus.coinbase_maturity}",
                )
        spent_coins.append(coin)

    value_in = sum(c.out.value for c in spent_coins)
    value_out = tx.total_output_value()
    if value_in < value_out:
        raise MempoolError("bad-txns-in-belowout", f"{value_in} < {value_out}")
    fee = value_in - value_out

    if require_standard and not are_inputs_standard(
        tx, [c.out for c in spent_coins]
    ):
        raise MempoolError("bad-txns-nonstandard-inputs")

    sigops = _tx_sigops(tx, spent_coins)
    if sigops > MAX_STANDARD_TX_SIGOPS:
        raise MempoolError("bad-txns-too-many-sigops", str(sigops))

    # nModifiedFees: a prioritisetransaction delta counts toward the fee
    # floor and every mining/eviction score, like the reference
    modified_fee = fee + pool.map_deltas.get(txid, 0)
    min_fee = get_min_relay_fee(tx.size(), min_fee_rate)
    if modified_fee < min_fee:
        raise MempoolError("mempool-min-fee-not-met",
                           f"{modified_fee} < {min_fee}")

    ancestors = pool.check_ancestor_limits(tx, fee,
                                           **(ancestor_limits or {}))
    t_scripts = _time.monotonic()
    _STAGE_H.labels(stage="context").observe(t_scripts - t_ctx)

    flags = standard_script_flags(params, height)
    verify_tx_scripts(tx, spent_coins, flags, sigcache, backend=backend,
                      sig_service=sig_service, wait_ctx=wait_ctx)
    if sig_service is not None and wait_ctx is not None:
        # cs_main may have been released during the SigService verdict
        # wait — every pool/chain fact above is a pre-wait snapshot.
        # Re-derive the cheap context; anything that moved retries the
        # whole acceptance (the sigcache now holds the verdicts, so the
        # re-run's verify is pure cache hits).
        if chainstate.tip() is not tip:
            raise _StaleContext
        if txid in pool:
            raise MempoolError("txn-already-in-mempool")
        for txin in tx.vin:
            spender = pool.get_spender(txin.prevout)
            if spender is not None:
                raise MempoolError("txn-mempool-conflict")
        for txin, coin in zip(tx.vin, spent_coins):
            if (coin.height == MEMPOOL_HEIGHT
                    and pool.get_output(txin.prevout) is None):
                raise _StaleContext  # in-pool parent vanished mid-wait
        # the ancestor package may have grown while unlocked
        ancestors = pool.check_ancestor_limits(tx, fee,
                                               **(ancestor_limits or {}))

    t_commit = _time.monotonic()
    _STAGE_H.labels(stage="scripts").observe(t_commit - t_scripts)
    entry = MempoolEntry(
        tx,
        modified_fee,
        now if now is not None else int(_time.time()),
        height,
        sigops=sigops,
        spends_coinbase=spends_coinbase,
        base_fee=fee,
    )
    pool.add_unchecked(entry, ancestors)
    removed = pool.trim_to_size()
    _STAGE_H.labels(stage="commit").observe(_time.monotonic() - t_commit)
    if txid not in pool:
        raise MempoolError("mempool-full", f"evicted with {len(removed) - 1} others")
    return entry
