"""EvalScript / VerifyScript — the Bitcoin Script stack machine.

Reference: src/script/interpreter.cpp:~250–1100 (EvalScript), :~1400
(VerifyScript), TransactionSignatureChecker::CheckSig, plus the signature/
pubkey encoding rules (IsValidSignatureEncoding, IsLowDERSignature,
CheckSignatureEncoding, CheckPubKeyEncoding).

TPU-first deferral (the CCheckQueue replacement, SURVEY.md §4.2): the
interpreter is branchy host code, but OP_CHECKSIG's expensive
secp256k1_ecdsa_verify is *deferred* — ``DeferringSignatureChecker``
records (pubkey, r, s, msghash) and speculatively reports success; the
per-block batch then runs in ONE TPU dispatch (ops/ecdsa_batch). This is
sound iff SCRIPT_VERIFY_NULLFAIL is active: a failing check with a
non-empty signature then always invalidates the script, so "all deferred
records verify" ⇔ "all scripts that reported success actually succeed".
The checker asserts that precondition. CHECKMULTISIG trials are verified
eagerly (sig→pubkey assignment is outcome-dependent, so deferral is
unsound there); multisig is rare and stays on the CPU fallback path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..consensus.tx import (
    SEQUENCE_LOCKTIME_DISABLE_FLAG,
    SEQUENCE_LOCKTIME_MASK,
    SEQUENCE_LOCKTIME_TYPE_FLAG,
    LOCKTIME_THRESHOLD,
    CTransaction,
)
from ..crypto import secp256k1 as secp
from ..crypto.hashes import hash160, ripemd160, sha256, sha256d
from . import script as S
from .script import (
    MAX_OPS_PER_SCRIPT,
    MAX_PUBKEYS_PER_MULTISIG,
    MAX_SCRIPT_ELEMENT_SIZE,
    MAX_SCRIPT_SIZE,
    MAX_STACK_SIZE,
    CScriptNum,
    ScriptNumError,
    ScriptParseError,
)
from .sighash import (
    SIGHASH_ANYONECANPAY,
    SIGHASH_FORKID,
    SIGHASH_SINGLE,
    SighashCache,
    signature_hash,
)

# ---- verification flags (src/script/interpreter.h) ----

SCRIPT_VERIFY_NONE = 0
SCRIPT_VERIFY_P2SH = 1 << 0
SCRIPT_VERIFY_STRICTENC = 1 << 1
SCRIPT_VERIFY_DERSIG = 1 << 2
SCRIPT_VERIFY_LOW_S = 1 << 3
SCRIPT_VERIFY_NULLDUMMY = 1 << 4
SCRIPT_VERIFY_SIGPUSHONLY = 1 << 5
SCRIPT_VERIFY_MINIMALDATA = 1 << 6
SCRIPT_VERIFY_DISCOURAGE_UPGRADABLE_NOPS = 1 << 7
SCRIPT_VERIFY_CLEANSTACK = 1 << 8
SCRIPT_VERIFY_CHECKLOCKTIMEVERIFY = 1 << 9
SCRIPT_VERIFY_CHECKSEQUENCEVERIFY = 1 << 10
SCRIPT_VERIFY_NULLFAIL = 1 << 14
SCRIPT_ENABLE_SIGHASH_FORKID = 1 << 16  # BCH-family [fork-delta, hedged]

# Consensus-mandatory flags for block validation (policy/policy.h
# MANDATORY_SCRIPT_VERIFY_FLAGS). Post-fork blocks add FORKID+NULLFAIL via
# validation/scriptcheck.block_script_flags.
MANDATORY_SCRIPT_VERIFY_FLAGS = SCRIPT_VERIFY_P2SH | SCRIPT_VERIFY_STRICTENC
STANDARD_SCRIPT_VERIFY_FLAGS = (
    MANDATORY_SCRIPT_VERIFY_FLAGS
    | SCRIPT_VERIFY_DERSIG
    | SCRIPT_VERIFY_LOW_S
    | SCRIPT_VERIFY_NULLDUMMY
    | SCRIPT_VERIFY_SIGPUSHONLY
    | SCRIPT_VERIFY_MINIMALDATA
    | SCRIPT_VERIFY_DISCOURAGE_UPGRADABLE_NOPS
    | SCRIPT_VERIFY_CLEANSTACK
    | SCRIPT_VERIFY_CHECKLOCKTIMEVERIFY
    | SCRIPT_VERIFY_CHECKSEQUENCEVERIFY
    | SCRIPT_VERIFY_NULLFAIL
)


class ScriptError(Exception):
    """script_error (src/script/script_error.h) — carries the reject code."""

    def __init__(self, code: str, detail: str = ""):
        self.code = code
        super().__init__(f"{code}{': ' + detail if detail else ''}")


# ---- signature / pubkey encoding (interpreter.cpp:~60–230) ----

def is_valid_signature_encoding(sig: bytes) -> bool:
    """IsValidSignatureEncoding — strict DER incl. 1-byte hashtype tail."""
    if len(sig) < 9 or len(sig) > 73:
        return False
    if sig[0] != 0x30 or sig[1] != len(sig) - 3:
        return False
    len_r = sig[3]
    if 5 + len_r >= len(sig):
        return False
    len_s = sig[5 + len_r]
    if len_r + len_s + 7 != len(sig):
        return False
    if sig[2] != 0x02 or len_r == 0 or (sig[4] & 0x80):
        return False
    if len_r > 1 and sig[4] == 0x00 and not (sig[5] & 0x80):
        return False
    if sig[len_r + 4] != 0x02 or len_s == 0 or (sig[len_r + 6] & 0x80):
        return False
    if len_s > 1 and sig[len_r + 6] == 0x00 and not (sig[len_r + 7] & 0x80):
        return False
    return True


def is_low_der_signature(sig: bytes) -> bool:
    """IsLowDERSignature: s <= n/2 (CPubKey::CheckLowS)."""
    if not is_valid_signature_encoding(sig):
        raise ScriptError("sig-der")
    rs = secp.sig_der_decode(sig[:-1])
    if rs is None:
        return False
    return rs[1] <= secp.N // 2


def is_defined_hashtype_signature(sig: bytes) -> bool:
    """IsDefinedHashtypeSignature: base type must be ALL/NONE/SINGLE (after
    stripping ANYONECANPAY and the fork's FORKID bit)."""
    if not sig:
        return False
    hashtype = sig[-1] & ~(SIGHASH_ANYONECANPAY | SIGHASH_FORKID)
    return 1 <= hashtype <= SIGHASH_SINGLE


def is_schnorr_signature(sig: bytes) -> bool:
    """BCH 2019-05 Schnorr discrimination (CheckTransactionECDSASignature-
    Encoding's complement): a transaction signature of exactly 65 bytes
    (64-byte r||s body + 1 hashtype byte) IS Schnorr, by consensus rule.
    DER encodings of 65 total bytes exist, but the upgrade removed them
    from validity — length alone decides, so there is no parse
    ambiguity."""
    return len(sig) == 65


def _check_hashtype_encoding(sig: bytes, flags: int) -> None:
    """The STRICTENC hashtype/forkid rules, shared by the DER and Schnorr
    encoding checks (the sighash byte plumbing is scheme-independent)."""
    if not is_defined_hashtype_signature(sig):
        raise ScriptError("sig-hashtype")
    uses_forkid = bool(sig[-1] & SIGHASH_FORKID)
    forkid_on = bool(flags & SCRIPT_ENABLE_SIGHASH_FORKID)
    if not forkid_on and uses_forkid:
        raise ScriptError("illegal-forkid")
    if forkid_on and not uses_forkid:
        raise ScriptError("must-use-forkid")


def check_signature_encoding(sig: bytes, flags: int) -> None:
    """CheckSignatureEncoding — raises ScriptError on violation."""
    if len(sig) == 0:
        return
    if is_schnorr_signature(sig):
        # Schnorr: the fixed-width encoding has no DER/low-s malleable
        # forms, so those checks don't apply — but the STRICTENC
        # hashtype/forkid rules still do
        if flags & SCRIPT_VERIFY_STRICTENC:
            _check_hashtype_encoding(sig, flags)
        return
    if flags & (
        SCRIPT_VERIFY_DERSIG | SCRIPT_VERIFY_LOW_S | SCRIPT_VERIFY_STRICTENC
    ) and not is_valid_signature_encoding(sig):
        raise ScriptError("sig-der")
    if flags & SCRIPT_VERIFY_LOW_S and not is_low_der_signature(sig):
        raise ScriptError("sig-high-s")
    if flags & SCRIPT_VERIFY_STRICTENC:
        _check_hashtype_encoding(sig, flags)


def check_pubkey_encoding(pubkey: bytes, flags: int) -> None:
    """CheckPubKeyEncoding: STRICTENC ⇒ compressed-or-uncompressed form."""
    if flags & SCRIPT_VERIFY_STRICTENC:
        ok = (
            (len(pubkey) == 33 and pubkey[0] in (2, 3))
            or (len(pubkey) == 65 and pubkey[0] == 4)
        )
        if not ok:
            raise ScriptError("pubkeytype")


def check_minimal_push(data: bytes, opcode: int) -> bool:
    """CheckMinimalPush (interpreter.cpp:~240)."""
    if len(data) == 0:
        return opcode == S.OP_0
    if len(data) == 1 and 1 <= data[0] <= 16:
        return opcode == S.OP_1 + data[0] - 1
    if len(data) == 1 and data[0] == 0x81:
        return opcode == S.OP_1NEGATE
    if len(data) <= 75:
        return opcode == len(data)
    if len(data) <= 255:
        return opcode == S.OP_PUSHDATA1
    if len(data) <= 65535:
        return opcode == S.OP_PUSHDATA2
    return True


def cast_to_bool(v: bytes) -> bool:
    """CastToBool: any non-zero byte, except a trailing negative-zero 0x80."""
    for i, b in enumerate(v):
        if b != 0:
            return not (i == len(v) - 1 and b == 0x80)
    return False


def _pubkey_parse_fast(pubkey: bytes):
    """pubkey_parse via the native module when present (the Python path's
    per-key modular sqrt was ~30% of reindex host time); oracle fallback.
    Same acceptance set (test_native.py differential)."""
    from .. import native

    if native.available():
        return native.pubkey_parse(pubkey)
    return secp.pubkey_parse(pubkey)


def _ecdsa_verify_scalar(pt, r: int, s: int, e: int) -> bool:
    """Scalar (non-batched) verify: the native C++ module when present
    (SURVEY §3.1 binding plan's CPU fallback — ~500x the Python oracle),
    else the oracle. Same acceptance set either way (test_native.py runs
    the differential)."""
    from .. import native

    if native.available():
        return native.ecdsa_verify(pt, r, s, e)
    return secp.ecdsa_verify(pt, r, s, e)


# ---- signature checkers (interpreter.h BaseSignatureChecker) ----

@dataclass
class SigCheckRecord:
    """One deferred signature verification — the unit the TPU batch
    consumes (pubkey point + (r,s) scalars + message-hash int, with
    attribution). ``algo`` discriminates the scheme: "ecdsa" records ride
    the per-lane GLV/w4 kernels, "schnorr" records are batchable into the
    MSM check (ops/ecdsa_batch partitions on this field)."""

    pubkey: tuple  # affine (x, y)
    r: int
    s: int
    msg_hash: int  # sighash as big-endian int
    txid: bytes = b""
    in_idx: int = -1
    algo: str = "ecdsa"


class BaseSignatureChecker:
    """No-transaction-context checker: every check fails (interpreter.h)."""

    def check_sig(self, sig: bytes, pubkey: bytes, script_code: bytes,
                  flags: int, defer_ok: bool = True) -> bool:
        return False

    def check_locktime(self, locktime: int) -> bool:
        return False

    def check_sequence(self, sequence: int) -> bool:
        return False


class TransactionSignatureChecker(BaseSignatureChecker):
    """TransactionSignatureChecker (interpreter.cpp): computes the sighash
    for (tx, in_idx, amount) and verifies via the CPU secp oracle."""

    def __init__(self, tx: CTransaction, in_idx: int, amount: int,
                 cache: Optional[SighashCache] = None):
        self.tx = tx
        self.in_idx = in_idx
        self.amount = amount
        self.cache = cache

    def _sighash_and_parse(self, sig: bytes, pubkey: bytes, script_code: bytes,
                           flags: int):
        """Shared parse path: returns (point, r, s, e, algo) or None if any
        parse fails (pubkey off-curve, empty/garbled sig). ``algo`` is
        "schnorr" for 65-byte signatures (BCH length discrimination),
        "ecdsa" for DER — both run over the SAME sighash digests."""
        if not sig:
            return None
        pt = _pubkey_parse_fast(pubkey)
        if pt is None:
            return None
        hashtype = sig[-1]
        if is_schnorr_signature(sig):
            algo = "schnorr"
            r = int.from_bytes(sig[0:32], "big")
            s = int.from_bytes(sig[32:64], "big")
        else:
            algo = "ecdsa"
            rs = secp.sig_der_decode(sig[:-1])
            if rs is None:
                return None
            r, s = rs
        ehash = signature_hash(
            script_code, self.tx, self.in_idx, hashtype, self.amount,
            enable_forkid=bool(flags & SCRIPT_ENABLE_SIGHASH_FORKID),
            cache=self.cache,
            strip_sig=S.push_data_raw(sig),
        )
        return pt, r, s, int.from_bytes(ehash, "big"), algo

    def check_sig(self, sig: bytes, pubkey: bytes, script_code: bytes,
                  flags: int, defer_ok: bool = True) -> bool:
        parsed = self._sighash_and_parse(sig, pubkey, script_code, flags)
        if parsed is None:
            return False
        pt, r, s, e, algo = parsed
        if algo == "schnorr":
            return secp.schnorr_verify(pt, r, s, e)
        return _ecdsa_verify_scalar(pt, r, s, e)

    def check_locktime(self, locktime: int) -> bool:
        """CheckLockTime (interpreter.cpp:~1230) — BIP65 semantics."""
        tx_lock = self.tx.locktime
        same_type = (
            (tx_lock < LOCKTIME_THRESHOLD and locktime < LOCKTIME_THRESHOLD)
            or (tx_lock >= LOCKTIME_THRESHOLD and locktime >= LOCKTIME_THRESHOLD)
        )
        if not same_type:
            return False
        if locktime > tx_lock:
            return False
        if self.tx.vin[self.in_idx].sequence == 0xFFFFFFFF:
            return False
        return True

    def check_sequence(self, sequence: int) -> bool:
        """CheckSequence (interpreter.cpp:~1270) — BIP112 semantics."""
        tx_seq = self.tx.vin[self.in_idx].sequence
        if self.tx.version < 2:
            return False
        if tx_seq & SEQUENCE_LOCKTIME_DISABLE_FLAG:
            return False
        mask = SEQUENCE_LOCKTIME_TYPE_FLAG | SEQUENCE_LOCKTIME_MASK
        masked_tx = tx_seq & mask
        masked_stack = sequence & mask
        same_type = (
            (masked_tx < SEQUENCE_LOCKTIME_TYPE_FLAG
             and masked_stack < SEQUENCE_LOCKTIME_TYPE_FLAG)
            or (masked_tx >= SEQUENCE_LOCKTIME_TYPE_FLAG
                and masked_stack >= SEQUENCE_LOCKTIME_TYPE_FLAG)
        )
        if not same_type:
            return False
        return masked_stack <= masked_tx


class DeferringSignatureChecker(TransactionSignatureChecker):
    """Records CHECKSIG verifications for the per-block TPU batch instead
    of running them. Requires NULLFAIL in flags (see module docstring);
    VerifyScript enforces this. Multisig trials (defer_ok=False) verify
    eagerly via the parent."""

    def __init__(self, tx: CTransaction, in_idx: int, amount: int,
                 records: list[SigCheckRecord],
                 cache: Optional[SighashCache] = None):
        super().__init__(tx, in_idx, amount, cache)
        self.records = records

    def check_sig(self, sig: bytes, pubkey: bytes, script_code: bytes,
                  flags: int, defer_ok: bool = True) -> bool:
        if not defer_ok:
            from ..ops.ecdsa_batch import STATS

            STATS.eager_multisig_sigs += 1
            return super().check_sig(sig, pubkey, script_code, flags, defer_ok)
        parsed = self._sighash_and_parse(sig, pubkey, script_code, flags)
        if parsed is None:
            return False
        pt, r, s, e, algo = parsed
        if algo == "schnorr":
            # Schnorr ranges: r is a field element, s a scalar (spec:
            # fail if r >= p or s >= n) — out-of-range never verifies
            if not (r < secp.P and s < secp.N):
                return False
        elif not (1 <= r < secp.N and 1 <= s < secp.N):
            return False  # out-of-range scalars never verify; don't defer
        self.records.append(
            SigCheckRecord(pt, r, s, e, self.tx.txid, self.in_idx, algo)
        )
        return True  # speculative success — batch settles it


# ---- EvalScript (interpreter.cpp:~250) ----

_DISABLED_OPCODES = frozenset({
    S.OP_CAT, S.OP_SUBSTR, S.OP_LEFT, S.OP_RIGHT,
    S.OP_INVERT, S.OP_AND, S.OP_OR, S.OP_XOR,
    S.OP_2MUL, S.OP_2DIV, S.OP_MUL, S.OP_DIV, S.OP_MOD,
    S.OP_LSHIFT, S.OP_RSHIFT,
})


def EvalScript(stack: list[bytes], script: bytes, flags: int,
               checker: BaseSignatureChecker) -> None:
    """Execute one script over ``stack`` in place. Raises ScriptError."""
    if len(script) > MAX_SCRIPT_SIZE:
        raise ScriptError("script-size")

    altstack: list[bytes] = []
    vexec: list[bool] = []  # conditional-execution stack (vfExec)
    op_count = 0
    minimal = bool(flags & SCRIPT_VERIFY_MINIMALDATA)
    pc = 0
    begincode = 0  # pbegincodehash: scriptCode start (OP_CODESEPARATOR)

    try:
        ops = list(S.get_script_ops(script))
    except ScriptParseError as e:
        raise ScriptError("bad-opcode", str(e)) from e

    def popstack() -> bytes:
        if not stack:
            raise ScriptError("invalid-stack-operation")
        return stack.pop()

    def popnum() -> int:
        return CScriptNum.decode(popstack(), minimal)

    def pushint(n: int) -> None:
        stack.append(CScriptNum.encode(n))

    def pushbool(b: bool) -> None:
        stack.append(b"\x01" if b else b"")

    try:
        for opcode, data, pc_after in ops:
            fexec = all(vexec)

            if data is not None and len(data) > MAX_SCRIPT_ELEMENT_SIZE:
                raise ScriptError("push-size")
            if opcode > S.OP_16:
                op_count += 1
                if op_count > MAX_OPS_PER_SCRIPT:
                    raise ScriptError("op-count")
            if opcode in _DISABLED_OPCODES:
                raise ScriptError("disabled-opcode")  # even if unexecuted

            if fexec and 0 <= opcode <= S.OP_PUSHDATA4:
                if minimal and not check_minimal_push(data, opcode):
                    raise ScriptError("minimaldata")
                stack.append(bytes(data))
            elif fexec or (S.OP_IF <= opcode <= S.OP_ENDIF):
                # ---- push small ints ----
                if opcode == S.OP_1NEGATE:
                    pushint(-1)
                elif S.OP_1 <= opcode <= S.OP_16:
                    pushint(opcode - (S.OP_1 - 1))

                # ---- control ----
                elif opcode == S.OP_NOP:
                    pass
                elif opcode == S.OP_CHECKLOCKTIMEVERIFY:
                    if not (flags & SCRIPT_VERIFY_CHECKLOCKTIMEVERIFY):
                        if flags & SCRIPT_VERIFY_DISCOURAGE_UPGRADABLE_NOPS:
                            raise ScriptError("discourage-upgradable-nops")
                    else:
                        if not stack:
                            raise ScriptError("invalid-stack-operation")
                        # 5-byte numeric operand (BIP65)
                        locktime = CScriptNum.decode(stack[-1], minimal, 5)
                        if locktime < 0:
                            raise ScriptError("negative-locktime")
                        if not checker.check_locktime(locktime):
                            raise ScriptError("unsatisfied-locktime")
                elif opcode == S.OP_CHECKSEQUENCEVERIFY:
                    if not (flags & SCRIPT_VERIFY_CHECKSEQUENCEVERIFY):
                        if flags & SCRIPT_VERIFY_DISCOURAGE_UPGRADABLE_NOPS:
                            raise ScriptError("discourage-upgradable-nops")
                    else:
                        if not stack:
                            raise ScriptError("invalid-stack-operation")
                        seq = CScriptNum.decode(stack[-1], minimal, 5)
                        if seq < 0:
                            raise ScriptError("negative-locktime")
                        if not (seq & SEQUENCE_LOCKTIME_DISABLE_FLAG):
                            if not checker.check_sequence(seq):
                                raise ScriptError("unsatisfied-locktime")
                elif opcode in (S.OP_NOP1, S.OP_NOP4, S.OP_NOP5, S.OP_NOP6,
                                S.OP_NOP7, S.OP_NOP8, S.OP_NOP9, S.OP_NOP10):
                    if flags & SCRIPT_VERIFY_DISCOURAGE_UPGRADABLE_NOPS:
                        raise ScriptError("discourage-upgradable-nops")
                elif opcode in (S.OP_IF, S.OP_NOTIF):
                    value = False
                    if fexec:
                        value = cast_to_bool(popstack())
                        if opcode == S.OP_NOTIF:
                            value = not value
                    vexec.append(value)
                elif opcode == S.OP_ELSE:
                    if not vexec:
                        raise ScriptError("unbalanced-conditional")
                    vexec[-1] = not vexec[-1]
                elif opcode == S.OP_ENDIF:
                    if not vexec:
                        raise ScriptError("unbalanced-conditional")
                    vexec.pop()
                elif opcode == S.OP_VERIFY:
                    if not cast_to_bool(popstack()):
                        raise ScriptError("verify")
                elif opcode == S.OP_RETURN:
                    raise ScriptError("op-return")
                elif opcode in (S.OP_VER, S.OP_VERIF, S.OP_VERNOTIF,
                                S.OP_RESERVED, S.OP_RESERVED1, S.OP_RESERVED2):
                    # VERIF/VERNOTIF fail even unexecuted in the reference;
                    # they reach here only via the IF..ENDIF passthrough
                    if opcode in (S.OP_VERIF, S.OP_VERNOTIF) or fexec:
                        raise ScriptError("bad-opcode")

                # ---- stack ----
                elif opcode == S.OP_TOALTSTACK:
                    altstack.append(popstack())
                elif opcode == S.OP_FROMALTSTACK:
                    if not altstack:
                        raise ScriptError("invalid-altstack-operation")
                    stack.append(altstack.pop())
                elif opcode == S.OP_2DROP:
                    popstack(); popstack()
                elif opcode == S.OP_2DUP:
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    stack.extend(stack[-2:])
                elif opcode == S.OP_3DUP:
                    if len(stack) < 3:
                        raise ScriptError("invalid-stack-operation")
                    stack.extend(stack[-3:])
                elif opcode == S.OP_2OVER:
                    if len(stack) < 4:
                        raise ScriptError("invalid-stack-operation")
                    stack.extend(stack[-4:-2])
                elif opcode == S.OP_2ROT:
                    if len(stack) < 6:
                        raise ScriptError("invalid-stack-operation")
                    x = stack[-6:-4]
                    del stack[-6:-4]
                    stack.extend(x)
                elif opcode == S.OP_2SWAP:
                    if len(stack) < 4:
                        raise ScriptError("invalid-stack-operation")
                    stack[-4:-2], stack[-2:] = stack[-2:], stack[-4:-2]
                elif opcode == S.OP_IFDUP:
                    if not stack:
                        raise ScriptError("invalid-stack-operation")
                    if cast_to_bool(stack[-1]):
                        stack.append(stack[-1])
                elif opcode == S.OP_DEPTH:
                    pushint(len(stack))
                elif opcode == S.OP_DROP:
                    popstack()
                elif opcode == S.OP_DUP:
                    if not stack:
                        raise ScriptError("invalid-stack-operation")
                    stack.append(stack[-1])
                elif opcode == S.OP_NIP:
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    del stack[-2]
                elif opcode == S.OP_OVER:
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    stack.append(stack[-2])
                elif opcode in (S.OP_PICK, S.OP_ROLL):
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    n = popnum()
                    if n < 0 or n >= len(stack):
                        raise ScriptError("invalid-stack-operation")
                    item = stack[-n - 1]
                    if opcode == S.OP_ROLL:
                        del stack[-n - 1]
                    stack.append(item)
                elif opcode == S.OP_ROT:
                    if len(stack) < 3:
                        raise ScriptError("invalid-stack-operation")
                    stack[-3], stack[-2], stack[-1] = (
                        stack[-2], stack[-1], stack[-3]
                    )
                elif opcode == S.OP_SWAP:
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    stack[-2], stack[-1] = stack[-1], stack[-2]
                elif opcode == S.OP_TUCK:
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    stack.insert(-2, stack[-1])
                elif opcode == S.OP_SIZE:
                    if not stack:
                        raise ScriptError("invalid-stack-operation")
                    pushint(len(stack[-1]))

                # ---- equality ----
                elif opcode in (S.OP_EQUAL, S.OP_EQUALVERIFY):
                    b1 = popstack()
                    b2 = popstack()
                    equal = b1 == b2
                    if opcode == S.OP_EQUALVERIFY:
                        if not equal:
                            raise ScriptError("equalverify")
                    else:
                        pushbool(equal)

                # ---- numeric ----
                elif opcode in (S.OP_1ADD, S.OP_1SUB, S.OP_NEGATE, S.OP_ABS,
                                S.OP_NOT, S.OP_0NOTEQUAL):
                    n = popnum()
                    if opcode == S.OP_1ADD:
                        n += 1
                    elif opcode == S.OP_1SUB:
                        n -= 1
                    elif opcode == S.OP_NEGATE:
                        n = -n
                    elif opcode == S.OP_ABS:
                        n = abs(n)
                    elif opcode == S.OP_NOT:
                        n = int(n == 0)
                    else:  # 0NOTEQUAL
                        n = int(n != 0)
                    pushint(n)
                elif opcode in (S.OP_ADD, S.OP_SUB, S.OP_BOOLAND, S.OP_BOOLOR,
                                S.OP_NUMEQUAL, S.OP_NUMEQUALVERIFY,
                                S.OP_NUMNOTEQUAL, S.OP_LESSTHAN,
                                S.OP_GREATERTHAN, S.OP_LESSTHANOREQUAL,
                                S.OP_GREATERTHANOREQUAL, S.OP_MIN, S.OP_MAX):
                    n2 = popnum()
                    n1 = popnum()
                    if opcode == S.OP_ADD:
                        out = n1 + n2
                    elif opcode == S.OP_SUB:
                        out = n1 - n2
                    elif opcode == S.OP_BOOLAND:
                        out = int(n1 != 0 and n2 != 0)
                    elif opcode == S.OP_BOOLOR:
                        out = int(n1 != 0 or n2 != 0)
                    elif opcode in (S.OP_NUMEQUAL, S.OP_NUMEQUALVERIFY):
                        out = int(n1 == n2)
                    elif opcode == S.OP_NUMNOTEQUAL:
                        out = int(n1 != n2)
                    elif opcode == S.OP_LESSTHAN:
                        out = int(n1 < n2)
                    elif opcode == S.OP_GREATERTHAN:
                        out = int(n1 > n2)
                    elif opcode == S.OP_LESSTHANOREQUAL:
                        out = int(n1 <= n2)
                    elif opcode == S.OP_GREATERTHANOREQUAL:
                        out = int(n1 >= n2)
                    elif opcode == S.OP_MIN:
                        out = min(n1, n2)
                    else:
                        out = max(n1, n2)
                    if opcode == S.OP_NUMEQUALVERIFY:
                        if not out:
                            raise ScriptError("numequalverify")
                    else:
                        pushint(out)
                elif opcode == S.OP_WITHIN:
                    n3 = popnum()
                    n2 = popnum()
                    n1 = popnum()
                    pushbool(n2 <= n1 < n3)

                # ---- crypto ----
                elif opcode in (S.OP_RIPEMD160, S.OP_SHA1, S.OP_SHA256,
                                S.OP_HASH160, S.OP_HASH256):
                    v = popstack()
                    if opcode == S.OP_RIPEMD160:
                        out_b = ripemd160(v)
                    elif opcode == S.OP_SHA1:
                        import hashlib
                        out_b = hashlib.sha1(v).digest()
                    elif opcode == S.OP_SHA256:
                        out_b = sha256(v)
                    elif opcode == S.OP_HASH160:
                        out_b = hash160(v)
                    else:
                        out_b = sha256d(v)
                    stack.append(out_b)
                elif opcode == S.OP_CODESEPARATOR:
                    begincode = pc_after
                elif opcode in (S.OP_CHECKSIG, S.OP_CHECKSIGVERIFY):
                    if len(stack) < 2:
                        raise ScriptError("invalid-stack-operation")
                    pubkey = popstack()
                    sig = stack.pop()  # order: sig below pubkey
                    # NB: reference pops (pubkey, sig) from top: sig is
                    # second from top. We popped pubkey then sig. Correct.
                    script_code = script[begincode:]
                    check_signature_encoding(sig, flags)
                    check_pubkey_encoding(pubkey, flags)
                    ok = checker.check_sig(sig, pubkey, script_code, flags)
                    if not ok and (flags & SCRIPT_VERIFY_NULLFAIL) and sig:
                        raise ScriptError("sig-nullfail")
                    if opcode == S.OP_CHECKSIGVERIFY:
                        if not ok:
                            raise ScriptError("checksigverify")
                    else:
                        pushbool(ok)
                elif opcode in (S.OP_CHECKMULTISIG, S.OP_CHECKMULTISIGVERIFY):
                    i = 1
                    if len(stack) < i:
                        raise ScriptError("invalid-stack-operation")
                    keys_count = CScriptNum.decode(stack[-i], minimal)
                    if keys_count < 0 or keys_count > MAX_PUBKEYS_PER_MULTISIG:
                        raise ScriptError("pubkey-count")
                    op_count += keys_count
                    if op_count > MAX_OPS_PER_SCRIPT:
                        raise ScriptError("op-count")
                    ikey = i + 1
                    i += keys_count + 1
                    if len(stack) < i:
                        raise ScriptError("invalid-stack-operation")
                    sigs_count = CScriptNum.decode(stack[-i], minimal)
                    if sigs_count < 0 or sigs_count > keys_count:
                        raise ScriptError("sig-count")
                    isig = i + 1
                    i += sigs_count + 1
                    if len(stack) < i:
                        raise ScriptError("invalid-stack-operation")

                    sigs = [stack[-(isig + k)] for k in range(sigs_count)]
                    keys = [stack[-(ikey + k)] for k in range(keys_count)]
                    # reference multisig FindAndDeletes EVERY sig from
                    # scriptCode before any CheckSig — EXCEPT when that
                    # sig uses the FORKID digest (CleanupScriptCode skips
                    # FindAndDelete for forkid signatures; stripping there
                    # would diverge from reference nodes on crafted
                    # redeem scripts embedding a signature push)
                    script_code = script[begincode:]
                    forkid_on = bool(flags & SCRIPT_ENABLE_SIGHASH_FORKID)
                    for sig in sigs:
                        if sig and not (forkid_on and sig[-1] & SIGHASH_FORKID):
                            script_code = S.find_and_delete(
                                script_code, S.push_data_raw(sig)
                            )

                    success = True
                    si, ki = 0, 0
                    while success and sigs_count - si > 0:
                        sig = sigs[si]
                        pubkey = keys[ki]
                        if is_schnorr_signature(sig):
                            # BCH consensus: 65-byte (Schnorr-sized) sigs
                            # are forbidden in legacy CHECKMULTISIG — the
                            # key-trial loop can't attribute a Schnorr sig
                            # to a key without running the verify, which
                            # defeats batching (spec 2019-05-15-schnorr)
                            raise ScriptError("sig-badlength")
                        check_signature_encoding(sig, flags)
                        check_pubkey_encoding(pubkey, flags)
                        ok = checker.check_sig(
                            sig, pubkey, script_code, flags, defer_ok=False
                        )
                        if ok:
                            si += 1
                        ki += 1
                        if sigs_count - si > keys_count - ki:
                            success = False
                    if not success and (flags & SCRIPT_VERIFY_NULLFAIL):
                        if any(s for s in sigs):
                            raise ScriptError("sig-nullfail")

                    # pop all sigs/keys/counts + the extra dummy element
                    for _ in range(i - 1):
                        popstack()
                    if not stack:
                        raise ScriptError("invalid-stack-operation")
                    dummy = popstack()
                    if (flags & SCRIPT_VERIFY_NULLDUMMY) and dummy:
                        raise ScriptError("sig-nulldummy")

                    if opcode == S.OP_CHECKMULTISIGVERIFY:
                        if not success:
                            raise ScriptError("checkmultisigverify")
                    else:
                        pushbool(success)
                else:
                    raise ScriptError("bad-opcode", f"0x{opcode:02x}")

            if len(stack) + len(altstack) > MAX_STACK_SIZE:
                raise ScriptError("stack-size")
    except ScriptNumError as e:
        raise ScriptError("unknown-error", str(e)) from e

    if vexec:
        raise ScriptError("unbalanced-conditional")


def VerifyScript(script_sig: bytes, script_pubkey: bytes, flags: int,
                 checker: BaseSignatureChecker) -> None:
    """VerifyScript (interpreter.cpp:~1400): run scriptSig then
    scriptPubKey (+ P2SH redeem script), enforce final-stack truth.
    Raises ScriptError; returns None on success."""
    if isinstance(checker, DeferringSignatureChecker):
        assert flags & SCRIPT_VERIFY_NULLFAIL, (
            "deferred sig batching requires NULLFAIL for soundness"
        )
    if (flags & SCRIPT_VERIFY_SIGPUSHONLY) and not S.is_push_only(script_sig):
        raise ScriptError("sig-pushonly")

    stack: list[bytes] = []
    EvalScript(stack, script_sig, flags, checker)
    stack_copy = list(stack) if flags & SCRIPT_VERIFY_P2SH else None
    EvalScript(stack, script_pubkey, flags, checker)
    if not stack:
        raise ScriptError("eval-false")
    if not cast_to_bool(stack[-1]):
        raise ScriptError("eval-false")

    # P2SH (interpreter.cpp:~1440)
    if (flags & SCRIPT_VERIFY_P2SH) and S.is_p2sh(script_pubkey):
        if not S.is_push_only(script_sig):
            raise ScriptError("sig-pushonly")
        stack = stack_copy
        assert stack  # scriptSig pushed at least the redeem script
        redeem = stack.pop()
        EvalScript(stack, redeem, flags, checker)
        if not stack:
            raise ScriptError("eval-false")
        if not cast_to_bool(stack[-1]):
            raise ScriptError("eval-false")

    if flags & SCRIPT_VERIFY_CLEANSTACK:
        assert flags & SCRIPT_VERIFY_P2SH  # reference asserts this pairing
        if len(stack) != 1:
            raise ScriptError("cleanstack")
