"""SignatureHash — the transaction digest that ECDSA signs.

Reference: src/script/interpreter.cpp:~1100 (SignatureHash). Two variants:

* **legacy** — the original algorithm: serialize a modified copy of the tx
  (inputs' scriptSigs replaced by scriptCode for the signed input, empty
  elsewhere; NONE/SINGLE/ANYONECANPAY mutations), append the 32-bit sighash
  type, SHA256d. Includes the notorious SIGHASH_SINGLE out-of-range "one"
  bug, reproduced bit-for-bit.
* **forkid (BIP143-style)** — the BCH-family replay-protected digest
  [fork-delta, hedged — SURVEY.md §0]: commits to hashPrevouts /
  hashSequence / hashOutputs midstates and the spent amount. Used when the
  signature's hashtype has SIGHASH_FORKID set and the
  SCRIPT_ENABLE_SIGHASH_FORKID flag is active (post-uahf_height blocks).

The midstate hashes (hash_prevouts etc.) are cacheable per transaction —
PrecomputedTransactionData in the reference — which turns sighash cost for
an n-input tx from O(n^2) to O(n). ``SighashCache`` provides that.
"""

from __future__ import annotations

from ..consensus.serialize import ser_u32, ser_u64, ser_var_bytes, ser_vector
from ..consensus.tx import CTransaction, CTxOut
from ..crypto.hashes import sha256d
from .script import OP_CODESEPARATOR, find_and_delete, get_script_ops

SIGHASH_ALL = 1
SIGHASH_NONE = 2
SIGHASH_SINGLE = 3
SIGHASH_FORKID = 0x40  # BCH-family replay protection bit
SIGHASH_ANYONECANPAY = 0x80

# SignatureHash returns this constant for the SINGLE-with-no-matching-output
# bug (uint256(1) — interpreter.cpp "one").
_ONE = (1).to_bytes(32, "little")


def strip_code_separators(script_code: bytes) -> bytes:
    """Remove OP_CODESEPARATOR opcodes — SignatureHash's scriptCode
    normalization (both variants do this)."""
    out = bytearray()
    pos = 0
    for op, _data, pc in get_script_ops(script_code):
        if op == OP_CODESEPARATOR:
            pos = pc
            continue
        out += script_code[pos:pc]
        pos = pc
    return bytes(out)


def signature_hash_legacy(
    script_code: bytes,
    tx: CTransaction,
    in_idx: int,
    hashtype: int,
    *,
    strip_sig: bytes | None = None,
) -> bytes:
    """Original SignatureHash (interpreter.cpp:~1100). ``strip_sig`` is the
    signature being checked; legacy sighash FindAndDelete's it from
    scriptCode (only relevant to pathological self-referencing scripts)."""
    if in_idx >= len(tx.vin):
        return _ONE  # "nIn out of range" bug path
    base_type = hashtype & 0x1F
    if base_type == SIGHASH_SINGLE and in_idx >= len(tx.vout):
        return _ONE  # the SIGHASH_SINGLE bug

    code = strip_code_separators(script_code)
    if strip_sig:
        code = find_and_delete(code, strip_sig)

    anyonecanpay = bool(hashtype & SIGHASH_ANYONECANPAY)

    # serialize CTransactionSignatureSerializer-style
    parts = [ser_u32(tx.version & 0xFFFFFFFF)]

    # inputs
    if anyonecanpay:
        vin = [tx.vin[in_idx]]
        idx_map = [in_idx]
    else:
        vin = list(tx.vin)
        idx_map = list(range(len(tx.vin)))
    in_parts = []
    for i, txin in zip(idx_map, vin):
        script = code if i == in_idx else b""
        seq = txin.sequence
        if i != in_idx and base_type in (SIGHASH_NONE, SIGHASH_SINGLE):
            seq = 0
        in_parts.append(
            txin.prevout.serialize() + ser_var_bytes(script) + ser_u32(seq)
        )
    parts.append(ser_vector(in_parts, lambda b: b))

    # outputs
    if base_type == SIGHASH_NONE:
        outs: list[CTxOut] = []
    elif base_type == SIGHASH_SINGLE:
        # outputs up to and including in_idx; earlier ones blanked
        outs = [CTxOut() for _ in range(in_idx)] + [tx.vout[in_idx]]
    else:
        outs = list(tx.vout)
    parts.append(ser_vector(outs, CTxOut.serialize))

    parts.append(ser_u32(tx.locktime))
    parts.append(ser_u32(hashtype & 0xFFFFFFFF))
    return sha256d(b"".join(parts))


class SighashCache:
    """PrecomputedTransactionData (src/script/interpreter.h): the three
    midstate hashes the forkid digest commits to, computed once per tx."""

    __slots__ = ("hash_prevouts", "hash_sequence", "hash_outputs")

    def __init__(self, tx: CTransaction):
        self.hash_prevouts = sha256d(
            b"".join(txin.prevout.serialize() for txin in tx.vin)
        )
        self.hash_sequence = sha256d(
            b"".join(ser_u32(txin.sequence) for txin in tx.vin)
        )
        self.hash_outputs = sha256d(
            b"".join(out.serialize() for out in tx.vout)
        )


def signature_hash_forkid(
    script_code: bytes,
    tx: CTransaction,
    in_idx: int,
    hashtype: int,
    amount: int,
    cache: SighashCache | None = None,
) -> bytes:
    """BIP143-style value-committing digest, selected by SIGHASH_FORKID
    (interpreter.cpp SignatureHash forkid branch) [fork-delta, hedged]."""
    assert in_idx < len(tx.vin)
    base_type = hashtype & 0x1F
    anyonecanpay = bool(hashtype & SIGHASH_ANYONECANPAY)
    cache = cache or SighashCache(tx)

    zero = b"\x00" * 32
    hash_prevouts = zero if anyonecanpay else cache.hash_prevouts
    if anyonecanpay or base_type in (SIGHASH_NONE, SIGHASH_SINGLE):
        hash_sequence = zero
    else:
        hash_sequence = cache.hash_sequence
    if base_type not in (SIGHASH_NONE, SIGHASH_SINGLE):
        hash_outputs = cache.hash_outputs
    elif base_type == SIGHASH_SINGLE and in_idx < len(tx.vout):
        hash_outputs = sha256d(tx.vout[in_idx].serialize())
    else:
        hash_outputs = zero

    # NB: unlike the legacy serializer, the forkid/BIP143-style branch
    # hashes scriptCode AS-IS — no OP_CODESEPARATOR stripping and no
    # FindAndDelete (the reference's SignatureHash forkid path serializes
    # the raw scriptCode).
    txin = tx.vin[in_idx]
    preimage = (
        ser_u32(tx.version & 0xFFFFFFFF)
        + hash_prevouts
        + hash_sequence
        + txin.prevout.serialize()
        + ser_var_bytes(script_code)
        + ser_u64(amount)
        + ser_u32(txin.sequence)
        + hash_outputs
        + ser_u32(tx.locktime)
        + ser_u32(hashtype & 0xFFFFFFFF)
    )
    return sha256d(preimage)


def signature_hash(
    script_code: bytes,
    tx: CTransaction,
    in_idx: int,
    hashtype: int,
    amount: int,
    *,
    enable_forkid: bool = False,
    cache: SighashCache | None = None,
    strip_sig: bytes | None = None,
) -> bytes:
    """Dispatch: forkid digest iff the hashtype carries SIGHASH_FORKID and
    the flag allows it; legacy otherwise — matching the reference's
    SignatureHash signature-type gate."""
    if enable_forkid and (hashtype & SIGHASH_FORKID):
        return signature_hash_forkid(script_code, tx, in_idx, hashtype, amount, cache)
    return signature_hash_legacy(
        script_code, tx, in_idx, hashtype, strip_sig=strip_sig
    )
