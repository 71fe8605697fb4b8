"""Transaction signing — the solver/sign glue.

Reference: src/script/sign.cpp (ProduceSignature, SignSignature, Solver
dispatch on script template). Supports P2PKH, P2PK, and P2SH-wrapped
multisig — the templates the node's own tests and wallet emit.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..consensus.tx import CTransaction, CTxIn
from ..script.script import (
    classify_script,
    get_script_ops,
    push_data_raw,
)
from ..script.sighash import (
    SIGHASH_ALL,
    SIGHASH_FORKID,
    SighashCache,
    signature_hash,
)
from .keys import CKey


class SignError(Exception):
    pass


def make_signature(
    key: CKey,
    script_code: bytes,
    tx: CTransaction,
    in_idx: int,
    amount: int,
    hashtype: int = SIGHASH_ALL,
    *,
    enable_forkid: bool = False,
    cache: Optional[SighashCache] = None,
) -> bytes:
    """One input signature: DER + 1-byte hashtype (sign.cpp ProduceSignature
    inner Sign1). Pass hashtype WITHOUT the forkid bit; it is added when
    enable_forkid is set (TransactionSignatureCreator does the same)."""
    if enable_forkid:
        hashtype |= SIGHASH_FORKID
    ehash = signature_hash(
        script_code, tx, in_idx, hashtype, amount,
        enable_forkid=enable_forkid, cache=cache,
    )
    return key.sign(ehash) + bytes([hashtype & 0xFF])


def solve_script_sig(
    script_pubkey: bytes,
    tx: CTransaction,
    in_idx: int,
    amount: int,
    key_for_id: Callable[[bytes], Optional[CKey]],
    hashtype: int = SIGHASH_ALL,
    *,
    enable_forkid: bool = False,
    redeem_script: Optional[bytes] = None,
    cache: Optional[SighashCache] = None,
) -> bytes:
    """Build a scriptSig for one input (sign.cpp SignStep).

    ``key_for_id`` maps a pubkey-hash (for pubkeyhash) or raw pubkey (for
    pubkey/multisig) to a CKey, or None if unknown.
    """
    kind = classify_script(script_pubkey)
    if kind == "pubkeyhash":
        ops = list(get_script_ops(script_pubkey))
        pkh = ops[2][1]
        key = key_for_id(pkh)
        if key is None:
            raise SignError("missing key for pubkeyhash")
        sig = make_signature(
            key, script_pubkey, tx, in_idx, amount, hashtype,
            enable_forkid=enable_forkid, cache=cache,
        )
        return push_data_raw(sig) + push_data_raw(key.pubkey)
    if kind == "pubkey":
        ops = list(get_script_ops(script_pubkey))
        pubkey = ops[0][1]
        key = key_for_id(pubkey)
        if key is None:
            raise SignError("missing key for pubkey")
        sig = make_signature(
            key, script_pubkey, tx, in_idx, amount, hashtype,
            enable_forkid=enable_forkid, cache=cache,
        )
        return push_data_raw(sig)
    if kind == "multisig":
        ops = list(get_script_ops(script_pubkey))
        m = ops[0][0] - 0x50
        sigs = []
        for _, pubkey, _ in ops[1:-2]:
            if len(sigs) == m:
                break
            key = key_for_id(pubkey)
            if key is None:
                continue
            sigs.append(
                make_signature(
                    key, script_pubkey, tx, in_idx, amount, hashtype,
                    enable_forkid=enable_forkid, cache=cache,
                )
            )
        if len(sigs) < m:
            raise SignError(f"only {len(sigs)} of {m} multisig keys known")
        out = b"\x00"  # OP_0 dummy (CHECKMULTISIG off-by-one)
        for sig in sigs:
            out += push_data_raw(sig)
        return out
    if kind == "scripthash":
        if redeem_script is None:
            raise SignError("missing redeem script for P2SH input")
        inner = solve_script_sig(
            redeem_script, tx, in_idx, amount, key_for_id, hashtype,
            enable_forkid=enable_forkid, cache=cache,
        )
        return inner + push_data_raw(redeem_script)
    raise SignError(f"cannot sign {kind} script")


def sign_transaction(
    tx: CTransaction,
    spent_outputs: list,  # list of (script_pubkey, amount) per input
    key_for_id: Callable[[bytes], Optional[CKey]],
    hashtype: int = SIGHASH_ALL,
    *,
    enable_forkid: bool = False,
    redeem_scripts: Optional[dict[bytes, bytes]] = None,  # hash160 -> script
) -> CTransaction:
    """SignSignature over every input; returns a new signed CTransaction.

    Signatures commit to the final scriptSig-free layout, so the unsigned
    ``tx`` must already have its full vin/vout; scriptSigs are replaced.
    """
    assert len(spent_outputs) == len(tx.vin)
    cache = SighashCache(tx)
    new_vin = []
    for i, (txin, (spk, amount)) in enumerate(zip(tx.vin, spent_outputs)):
        redeem = None
        if redeem_scripts and classify_script(spk) == "scripthash":
            redeem = redeem_scripts.get(spk[2:22])
        script_sig = solve_script_sig(
            spk, tx, i, amount, key_for_id, hashtype,
            enable_forkid=enable_forkid, redeem_script=redeem, cache=cache,
        )
        new_vin.append(CTxIn(txin.prevout, script_sig, txin.sequence))
    return CTransaction(tx.version, tuple(new_vin), tx.vout, tx.locktime)
