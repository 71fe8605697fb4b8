"""Context-free transaction and block sanity checks.

Reference: src/consensus/tx_verify.cpp (CheckTransaction) — 0.15 lineage
moves these out of validation.cpp; same rules either way. Amount rules
from src/amount.h (MoneyRange).
"""

from __future__ import annotations

from .tx import MAX_MONEY, CTransaction, money_range

# Consensus size limits (src/consensus/consensus.h). The BCH-family lineage
# raises the block size cap; we keep it a ChainParams field
# (params.consensus.max_block_size) and use these only as defaults.
MAX_BLOCK_SIZE = 8_000_000  # [fork-delta, hedged] 8MB Bitcoin-Cash-family cap
LEGACY_MAX_BLOCK_SIZE = 1_000_000
MAX_BLOCK_SIGOPS_PER_MB = 20_000
COINBASE_MATURITY = 100  # src/consensus/consensus.h (COINBASE_MATURITY)


class TxValidationError(ValueError):
    """Carries the reference's reject reason string (e.g. 'bad-txns-vin-empty')
    so functional tests can assert on exact reasons like the reference's."""

    def __init__(self, reason: str, debug: str = ""):
        super().__init__(reason + (f" ({debug})" if debug else ""))
        self.reason = reason
        self.debug = debug


LOCKTIME_THRESHOLD = 500_000_000  # script.h: below = height, above = unix time


def is_final_tx(tx: CTransaction, block_height: int, block_time: int) -> bool:
    """IsFinalTx (src/consensus/tx_verify.cpp:~17). ``block_time`` is the
    median-time-past under BIP113 semantics (callers pass MTP)."""
    if tx.locktime == 0:
        return True
    cutoff = block_height if tx.locktime < LOCKTIME_THRESHOLD else block_time
    if tx.locktime < cutoff:
        return True
    return all(txin.sequence == 0xFFFFFFFF for txin in tx.vin)


def check_transaction(tx: CTransaction) -> None:
    """CheckTransaction (src/consensus/tx_verify.cpp:~160): context-free
    sanity. Raises TxValidationError with the reference's reject reason."""
    if not tx.vin:
        raise TxValidationError("bad-txns-vin-empty")
    if not tx.vout:
        raise TxValidationError("bad-txns-vout-empty")
    # Size bound is checked against the serialized size at block level; the
    # per-tx bound mirrors the reference's ::GetSerializeSize check.
    if tx.size() > MAX_BLOCK_SIZE:
        raise TxValidationError("bad-txns-oversize")

    total = 0
    for out in tx.vout:
        if out.value < 0:
            raise TxValidationError("bad-txns-vout-negative")
        if out.value > MAX_MONEY:
            raise TxValidationError("bad-txns-vout-toolarge")
        total += out.value
        if not money_range(total):
            raise TxValidationError("bad-txns-txouttotal-toolarge")

    seen = set()
    for txin in tx.vin:
        if txin.prevout in seen:
            raise TxValidationError("bad-txns-inputs-duplicate")
        seen.add(txin.prevout)

    if tx.is_coinbase():
        if not (2 <= len(tx.vin[0].script_sig) <= 100):
            raise TxValidationError("bad-cb-length")
    else:
        for txin in tx.vin:
            if txin.prevout.is_null():
                raise TxValidationError("bad-txns-prevout-null")
