"""Relay policy — standardness rules.

Reference: src/policy/policy.{h,cpp} (IsStandardTx, IsStandard,
AreInputsStandard, GetDustThreshold), src/policy/feerate (CFeeRate).
Policy ≠ consensus: these gate mempool admission only.
"""

from __future__ import annotations

from ..consensus.tx import CTransaction
from ..script.script import (
    MAX_SCRIPT_SIZE,
    classify_script,
    count_sigops,
    get_script_ops,
    is_push_only,
)

MAX_STANDARD_TX_SIZE = 100_000  # MAX_STANDARD_TX_SIZE (policy.h)
MAX_STANDARD_SCRIPTSIG_SIZE = 1650
MAX_P2SH_SIGOPS = 15
MAX_OP_RETURN_RELAY = 83  # nMaxDatacarrierBytes
DEFAULT_MIN_RELAY_FEE_RATE = 1000  # sat/kB (DEFAULT_MIN_RELAY_TX_FEE)


def get_min_relay_fee(tx_size: int,
                      rate: int = DEFAULT_MIN_RELAY_FEE_RATE) -> int:
    """CFeeRate::GetFee — rounds up to at least 1 sat when rate > 0."""
    fee = rate * tx_size // 1000
    if fee == 0 and rate > 0:
        fee = rate
    return fee


def get_dust_threshold(txout,
                       rate: int = DEFAULT_MIN_RELAY_FEE_RATE) -> int:
    """GetDustThreshold (policy.h IsDust): an output is dust when spending
    it would cost more than 1/3 of its value — threshold = 3 × relay fee on
    (serialized output + 148 bytes of spending input). 546 sat for P2PKH at
    the default rate; larger scripts scale up."""
    size = len(txout.serialize()) + 148
    return 3 * get_min_relay_fee(size, rate)


def is_standard_tx(tx: CTransaction) -> tuple[bool, str]:
    """IsStandardTx (policy.cpp:~60). Returns (ok, reason)."""
    if tx.version > CTransaction.CURRENT_VERSION or tx.version < 1:
        return False, "version"
    if tx.size() > MAX_STANDARD_TX_SIZE:
        return False, "tx-size"
    for txin in tx.vin:
        if len(txin.script_sig) > MAX_STANDARD_SCRIPTSIG_SIZE:
            return False, "scriptsig-size"
        if not is_push_only(txin.script_sig):
            return False, "scriptsig-not-pushonly"
    n_data = 0
    for txout in tx.vout:
        kind = classify_script(txout.script_pubkey)
        if kind == "nonstandard":
            return False, "scriptpubkey"
        if kind == "nulldata":
            n_data += 1
            if len(txout.script_pubkey) > MAX_OP_RETURN_RELAY:
                return False, "oversize-op-return"
        elif txout.value < get_dust_threshold(txout):
            return False, "dust"
    if n_data > 1:
        return False, "multi-op-return"
    return True, ""


def are_inputs_standard(tx: CTransaction, spent_outputs: list) -> bool:
    """AreInputsStandard (policy.cpp:~150): P2SH redeem scripts bounded to
    MAX_P2SH_SIGOPS; inputs must spend known templates.
    ``spent_outputs``: CTxOut per input."""
    if tx.is_coinbase():
        return True
    for txin, prevout in zip(tx.vin, spent_outputs):
        kind = classify_script(prevout.script_pubkey)
        if kind == "nonstandard":
            return False
        if kind == "scripthash":
            # last push of scriptSig is the redeem script
            redeem = b""
            try:
                for op, data, _ in get_script_ops(txin.script_sig):
                    redeem = data or b""
            except Exception:
                return False
            if len(redeem) > MAX_SCRIPT_SIZE:
                return False
            if count_sigops(redeem, accurate=True) > MAX_P2SH_SIGOPS:
                return False
    return True
