"""CScript: opcodes, script numbers, templates, sigop counting.

Reference: src/script/script.{h,cpp} (opcodetype enum, CScriptNum,
CScript::GetSigOpCount, IsPayToScriptHash, IsPushOnly) and
src/script/standard.cpp (output templates). Scripts are plain ``bytes``
here — the reference's CScript is a byte vector with helper methods; we
keep the bytes and provide free functions, which serializes identically.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..crypto.hashes import hash160

# ---- opcodes (src/script/script.h opcodetype) ----

# push value
OP_0 = OP_FALSE = 0x00
OP_PUSHDATA1 = 0x4C
OP_PUSHDATA2 = 0x4D
OP_PUSHDATA4 = 0x4E
OP_1NEGATE = 0x4F
OP_RESERVED = 0x50
OP_1 = OP_TRUE = 0x51
OP_2 = 0x52
OP_3 = 0x53
OP_4 = 0x54
OP_5 = 0x55
OP_6 = 0x56
OP_7 = 0x57
OP_8 = 0x58
OP_9 = 0x59
OP_10 = 0x5A
OP_11 = 0x5B
OP_12 = 0x5C
OP_13 = 0x5D
OP_14 = 0x5E
OP_15 = 0x5F
OP_16 = 0x60

# control
OP_NOP = 0x61
OP_VER = 0x62
OP_IF = 0x63
OP_NOTIF = 0x64
OP_VERIF = 0x65
OP_VERNOTIF = 0x66
OP_ELSE = 0x67
OP_ENDIF = 0x68
OP_VERIFY = 0x69
OP_RETURN = 0x6A

# stack ops
OP_TOALTSTACK = 0x6B
OP_FROMALTSTACK = 0x6C
OP_2DROP = 0x6D
OP_2DUP = 0x6E
OP_3DUP = 0x6F
OP_2OVER = 0x70
OP_2ROT = 0x71
OP_2SWAP = 0x72
OP_IFDUP = 0x73
OP_DEPTH = 0x74
OP_DROP = 0x75
OP_DUP = 0x76
OP_NIP = 0x77
OP_OVER = 0x78
OP_PICK = 0x79
OP_ROLL = 0x7A
OP_ROT = 0x7B
OP_SWAP = 0x7C
OP_TUCK = 0x7D

# splice ops (disabled in this lineage)
OP_CAT = 0x7E
OP_SUBSTR = 0x7F
OP_LEFT = 0x80
OP_RIGHT = 0x81
OP_SIZE = 0x82

# bit logic (disabled except EQUAL/EQUALVERIFY)
OP_INVERT = 0x83
OP_AND = 0x84
OP_OR = 0x85
OP_XOR = 0x86
OP_EQUAL = 0x87
OP_EQUALVERIFY = 0x88
OP_RESERVED1 = 0x89
OP_RESERVED2 = 0x8A

# numeric
OP_1ADD = 0x8B
OP_1SUB = 0x8C
OP_2MUL = 0x8D
OP_2DIV = 0x8E
OP_NEGATE = 0x8F
OP_ABS = 0x90
OP_NOT = 0x91
OP_0NOTEQUAL = 0x92
OP_ADD = 0x93
OP_SUB = 0x94
OP_MUL = 0x95
OP_DIV = 0x96
OP_MOD = 0x97
OP_LSHIFT = 0x98
OP_RSHIFT = 0x99
OP_BOOLAND = 0x9A
OP_BOOLOR = 0x9B
OP_NUMEQUAL = 0x9C
OP_NUMEQUALVERIFY = 0x9D
OP_NUMNOTEQUAL = 0x9E
OP_LESSTHAN = 0x9F
OP_GREATERTHAN = 0xA0
OP_LESSTHANOREQUAL = 0xA1
OP_GREATERTHANOREQUAL = 0xA2
OP_MIN = 0xA3
OP_MAX = 0xA4
OP_WITHIN = 0xA5

# crypto
OP_RIPEMD160 = 0xA6
OP_SHA1 = 0xA7
OP_SHA256 = 0xA8
OP_HASH160 = 0xA9
OP_HASH256 = 0xAA
OP_CODESEPARATOR = 0xAB
OP_CHECKSIG = 0xAC
OP_CHECKSIGVERIFY = 0xAD
OP_CHECKMULTISIG = 0xAE
OP_CHECKMULTISIGVERIFY = 0xAF

# expansion
OP_NOP1 = 0xB0
OP_CHECKLOCKTIMEVERIFY = OP_NOP2 = 0xB1
OP_CHECKSEQUENCEVERIFY = OP_NOP3 = 0xB2
OP_NOP4 = 0xB3
OP_NOP5 = 0xB4
OP_NOP6 = 0xB5
OP_NOP7 = 0xB6
OP_NOP8 = 0xB7
OP_NOP9 = 0xB8
OP_NOP10 = 0xB9

OP_INVALIDOPCODE = 0xFF

# consensus limits (src/script/script.h)
MAX_SCRIPT_ELEMENT_SIZE = 520
MAX_OPS_PER_SCRIPT = 201
MAX_PUBKEYS_PER_MULTISIG = 20
MAX_SCRIPT_SIZE = 10_000
MAX_STACK_SIZE = 1_000


class ScriptParseError(ValueError):
    """Malformed pushdata — CScript::GetOp returning false."""


class ScriptNumError(ValueError):
    """CScriptNum overflow / non-minimal encoding (scriptnum_error)."""


class CScriptNum:
    """Numeric stack-element codec — CScriptNum (src/script/script.h:~190).

    Little-endian sign-magnitude with a sign bit in the top byte's MSB.
    Operands are limited to 4 bytes on input (results may be 5)."""

    DEFAULT_MAX_SIZE = 4

    @staticmethod
    def encode(n: int) -> bytes:
        if n == 0:
            return b""
        neg = n < 0
        absvalue = -n if neg else n
        out = bytearray()
        while absvalue:
            out.append(absvalue & 0xFF)
            absvalue >>= 8
        if out[-1] & 0x80:
            out.append(0x80 if neg else 0x00)
        elif neg:
            out[-1] |= 0x80
        return bytes(out)

    @staticmethod
    def decode(data: bytes, require_minimal: bool = False,
               max_size: int = DEFAULT_MAX_SIZE) -> int:
        if len(data) > max_size:
            raise ScriptNumError("script number overflow")
        if require_minimal and data:
            # top byte must carry information beyond the sign bit
            if data[-1] & 0x7F == 0 and (
                len(data) <= 1 or data[-2] & 0x80 == 0
            ):
                raise ScriptNumError("non-minimally encoded script number")
        if not data:
            return 0
        result = 0
        for i, b in enumerate(data):
            result |= b << (8 * i)
        if data[-1] & 0x80:
            return -(result & ~(0x80 << (8 * (len(data) - 1))))
        return result


def push_data(data: bytes) -> bytes:
    """Serialize a data push — CScript operator<<(vector) semantics."""
    n = len(data)
    if n == 0:
        return bytes([OP_0])
    if n == 1 and 1 <= data[0] <= 16:
        return bytes([OP_1 + data[0] - 1])
    if n == 1 and data[0] == 0x81:
        return bytes([OP_1NEGATE])
    if n < OP_PUSHDATA1:
        return bytes([n]) + data
    if n <= 0xFF:
        return bytes([OP_PUSHDATA1, n]) + data
    if n <= 0xFFFF:
        return bytes([OP_PUSHDATA2]) + n.to_bytes(2, "little") + data
    return bytes([OP_PUSHDATA4]) + n.to_bytes(4, "little") + data


def push_data_raw(data: bytes) -> bytes:
    """Direct-length push without the small-int opcode shortcut — what
    signature/pubkey pushes in real scriptSigs look like."""
    n = len(data)
    if n < OP_PUSHDATA1:
        return bytes([n]) + data
    if n <= 0xFF:
        return bytes([OP_PUSHDATA1, n]) + data
    if n <= 0xFFFF:
        return bytes([OP_PUSHDATA2]) + n.to_bytes(2, "little") + data
    return bytes([OP_PUSHDATA4]) + n.to_bytes(4, "little") + data


def script_int(n: int) -> bytes:
    """CScript << n: OP_0/OP_1..OP_16/OP_1NEGATE for small values, else a
    CScriptNum push. This is the BIP34 height encoding (src/miner.cpp uses
    CScript() << nHeight)."""
    if n == 0:
        return bytes([OP_0])
    if n == -1:
        return bytes([OP_1NEGATE])
    if 1 <= n <= 16:
        return bytes([OP_1 + n - 1])
    return push_data(CScriptNum.encode(n))


def get_script_ops(script: bytes) -> Iterator[tuple[int, Optional[bytes], int]]:
    """Iterate (opcode, pushed_data_or_None, pc_after) — CScript::GetOp.
    Raises ScriptParseError on truncated pushdata."""
    pc = 0
    end = len(script)
    while pc < end:
        opcode = script[pc]
        pc += 1
        data = None
        if opcode <= OP_PUSHDATA4:
            if opcode < OP_PUSHDATA1:
                size = opcode
            elif opcode == OP_PUSHDATA1:
                if pc + 1 > end:
                    raise ScriptParseError("truncated PUSHDATA1 length")
                size = script[pc]
                pc += 1
            elif opcode == OP_PUSHDATA2:
                if pc + 2 > end:
                    raise ScriptParseError("truncated PUSHDATA2 length")
                size = int.from_bytes(script[pc : pc + 2], "little")
                pc += 2
            else:  # OP_PUSHDATA4
                if pc + 4 > end:
                    raise ScriptParseError("truncated PUSHDATA4 length")
                size = int.from_bytes(script[pc : pc + 4], "little")
                pc += 4
            if pc + size > end:
                raise ScriptParseError("push past end of script")
            data = script[pc : pc + size]
            pc += size
        yield opcode, data, pc


def decode_op_n(opcode: int) -> int:
    """CScript::DecodeOP_N."""
    if opcode == OP_0:
        return 0
    assert OP_1 <= opcode <= OP_16
    return opcode - (OP_1 - 1)


def is_push_only(script: bytes) -> bool:
    """CScript::IsPushOnly — every op <= OP_16 (includes 1NEGATE/reserved)."""
    try:
        return all(op <= OP_16 for op, _, _ in get_script_ops(script))
    except ScriptParseError:
        return False


def is_p2sh(script_pubkey: bytes) -> bool:
    """CScript::IsPayToScriptHash: HASH160 <20 bytes> EQUAL, exactly."""
    return (
        len(script_pubkey) == 23
        and script_pubkey[0] == OP_HASH160
        and script_pubkey[1] == 0x14
        and script_pubkey[22] == OP_EQUAL
    )


def is_unspendable(script_pubkey: bytes) -> bool:
    """CScript::IsUnspendable: OP_RETURN-led or oversized."""
    return (
        (len(script_pubkey) > 0 and script_pubkey[0] == OP_RETURN)
        or len(script_pubkey) > MAX_SCRIPT_SIZE
    )


# ---- standard output templates (src/script/standard.cpp Solver) ----

def p2pkh_script(pubkey_hash: bytes) -> bytes:
    """DUP HASH160 <hash160> EQUALVERIFY CHECKSIG."""
    assert len(pubkey_hash) == 20
    return (
        bytes([OP_DUP, OP_HASH160, 20]) + pubkey_hash
        + bytes([OP_EQUALVERIFY, OP_CHECKSIG])
    )


def p2pkh_script_for_pubkey(pubkey: bytes) -> bytes:
    return p2pkh_script(hash160(pubkey))


def p2pk_script(pubkey: bytes) -> bytes:
    """<pubkey> CHECKSIG."""
    return push_data_raw(pubkey) + bytes([OP_CHECKSIG])


def p2sh_script(script_hash: bytes) -> bytes:
    """HASH160 <hash160> EQUAL."""
    assert len(script_hash) == 20
    return bytes([OP_HASH160, 20]) + script_hash + bytes([OP_EQUAL])


def p2sh_script_for_redeem(redeem_script: bytes) -> bytes:
    return p2sh_script(hash160(redeem_script))


def multisig_script(m: int, pubkeys: list[bytes]) -> bytes:
    """m <pk...> n CHECKMULTISIG."""
    assert 1 <= m <= len(pubkeys) <= MAX_PUBKEYS_PER_MULTISIG
    out = script_int(m)
    for pk in pubkeys:
        out += push_data_raw(pk)
    return out + script_int(len(pubkeys)) + bytes([OP_CHECKMULTISIG])


def null_data_script(data: bytes) -> bytes:
    """OP_RETURN <data> (standard.cpp TX_NULL_DATA)."""
    return bytes([OP_RETURN]) + push_data(data)


def classify_script(script_pubkey: bytes) -> str:
    """Solver (src/script/standard.cpp:~30) — returns one of
    'pubkey' | 'pubkeyhash' | 'scripthash' | 'multisig' | 'nulldata' |
    'nonstandard'."""
    if is_p2sh(script_pubkey):
        return "scripthash"
    try:
        ops = list(get_script_ops(script_pubkey))
    except ScriptParseError:
        return "nonstandard"
    if len(script_pubkey) >= 1 and script_pubkey[0] == OP_RETURN:
        if is_push_only(script_pubkey[1:]):
            return "nulldata"
        return "nonstandard"
    if (
        len(ops) == 5
        and ops[0][0] == OP_DUP and ops[1][0] == OP_HASH160
        and ops[2][1] is not None and len(ops[2][1]) == 20
        and ops[3][0] == OP_EQUALVERIFY and ops[4][0] == OP_CHECKSIG
    ):
        return "pubkeyhash"
    if (
        len(ops) == 2 and ops[1][0] == OP_CHECKSIG
        and ops[0][1] is not None and len(ops[0][1]) in (33, 65)
    ):
        return "pubkey"
    if (
        len(ops) >= 4 and ops[-1][0] == OP_CHECKMULTISIG
        and OP_1 <= ops[0][0] <= OP_16 and OP_1 <= ops[-2][0] <= OP_16
    ):
        m = decode_op_n(ops[0][0])
        n = decode_op_n(ops[-2][0])
        keys = ops[1:-2]
        if (
            1 <= m <= n <= MAX_PUBKEYS_PER_MULTISIG and len(keys) == n
            and all(k[1] is not None and len(k[1]) in (33, 65) for k in keys)
        ):
            return "multisig"
    return "nonstandard"


def count_sigops(script: bytes, accurate: bool = False) -> int:
    """CScript::GetSigOpCount (src/script/script.cpp:~150): CHECKSIG counts
    1, CHECKMULTISIG counts 20 — or, in 'accurate' mode (P2SH redeem
    scripts), the preceding OP_N when present. Parse errors truncate the
    count, as the reference's GetOp loop does."""
    n = 0
    last_opcode = OP_INVALIDOPCODE
    try:
        for opcode, _, _ in get_script_ops(script):
            if opcode in (OP_CHECKSIG, OP_CHECKSIGVERIFY):
                n += 1
            elif opcode in (OP_CHECKMULTISIG, OP_CHECKMULTISIGVERIFY):
                if accurate and OP_1 <= last_opcode <= OP_16:
                    n += decode_op_n(last_opcode)
                else:
                    n += MAX_PUBKEYS_PER_MULTISIG
            last_opcode = opcode
    except ScriptParseError:
        pass
    return n


def count_p2sh_sigops(script_pubkey: bytes, script_sig: bytes) -> int:
    """CScript::GetSigOpCount(scriptSig) for P2SH: sigops of the redeem
    script (the last push of scriptSig), accurate mode."""
    if not is_p2sh(script_pubkey):
        return 0
    redeem = b""
    try:
        for op, data, _ in get_script_ops(script_sig):
            if op > OP_16:
                return 0  # non-push-only: invalid spend, no sigops
            redeem = data or b""
    except ScriptParseError:
        return 0
    return count_sigops(redeem, accurate=True)


def find_and_delete(script: bytes, elem: bytes) -> bytes:
    """CScript::FindAndDelete — remove every serialized occurrence of
    ``elem`` (as full pushes) from the script. Used by the legacy sighash
    to strip the signature from scriptCode."""
    if not elem:
        return script
    out = bytearray()
    pc = 0
    end = len(script)
    while pc < end:
        # match at op boundaries only, like the reference
        if script[pc : pc + len(elem)] == elem:
            pc += len(elem)
            continue
        start = pc
        opcode = script[pc]
        pc += 1
        if opcode <= OP_PUSHDATA4:
            if opcode < OP_PUSHDATA1:
                size = opcode
            elif opcode == OP_PUSHDATA1:
                size = script[pc] if pc < end else 0
                pc += 1
            elif opcode == OP_PUSHDATA2:
                size = int.from_bytes(script[pc : pc + 2], "little")
                pc += 2
            else:
                size = int.from_bytes(script[pc : pc + 4], "little")
                pc += 4
            pc += size
        out += script[start : min(pc, end)]
    return bytes(out)


# ---- opcode names (GetOpName, src/script/script.cpp) ----

OPCODE_NAMES: dict[int, str] = {
    v: k
    for k, v in sorted(globals().items())
    if k.startswith("OP_") and isinstance(v, int)
}
# canonical spellings where aliases exist
OPCODE_NAMES[0x00] = "0"
OPCODE_NAMES[0x51] = "OP_1"
OPCODE_NAMES[0x87] = "OP_EQUAL"
