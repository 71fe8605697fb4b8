"""Bitcoin Script — the L3 consensus script layer.

Reference: src/script/ (script.{h,cpp} — CScript + opcodes;
interpreter.{h,cpp} — EvalScript/VerifyScript/SignatureHash;
standard.{h,cpp} — output classification; sign.cpp — solver/signing glue).

TPU-first split: the stack machine itself is branchy host code (not
TPU-able, SURVEY.md §3.1), but it *defers* the expensive ECDSA verifies
into per-block sigcheck records that ops/ecdsa_batch ships to the chip in
one dispatch. Sighash preimage construction lives here; the double-SHA of
those preimages can batch on-chip as well.
"""

from .script import (  # noqa: F401
    OP_0, OP_1, OP_16, OP_CHECKSIG, OP_DUP, OP_EQUAL, OP_EQUALVERIFY,
    OP_HASH160, OP_RETURN, CScriptNum, ScriptNumError,
    p2pkh_script, p2pk_script, p2sh_script, script_int,
    get_script_ops, is_p2sh, is_push_only, count_sigops,
)
from .interpreter import (  # noqa: F401
    SCRIPT_VERIFY_NONE, SCRIPT_VERIFY_P2SH, SCRIPT_VERIFY_STRICTENC,
    SCRIPT_VERIFY_DERSIG, SCRIPT_VERIFY_LOW_S, SCRIPT_VERIFY_NULLDUMMY,
    SCRIPT_VERIFY_NULLFAIL, SCRIPT_ENABLE_SIGHASH_FORKID,
    MANDATORY_SCRIPT_VERIFY_FLAGS, STANDARD_SCRIPT_VERIFY_FLAGS,
    ScriptError, EvalScript, VerifyScript,
    BaseSignatureChecker, TransactionSignatureChecker,
    DeferringSignatureChecker, SigCheckRecord,
)
from .sighash import (  # noqa: F401
    SIGHASH_ALL, SIGHASH_NONE, SIGHASH_SINGLE, SIGHASH_ANYONECANPAY,
    SIGHASH_FORKID, signature_hash, signature_hash_legacy,
    signature_hash_forkid,
)
