"""ctypes bindings for the native runtime library (native/bcp_native.cpp).

The reference's runtime around the compute path is C++ (serialization
templates, src/crypto/sha256.cpp, merkle.cpp); here the equivalent native
layer accelerates the HOST side of -reindex / block-store scans: wire
parsing (tx boundaries + txids), batch header hashing, merkle roots. The
TPU kernels remain the device compute path; Python remains the consensus
reference — callers treat this as an optional accelerator and every
function is differential-tested against the Python implementation
(tests/unit/test_native.py).

`load()` finds (or builds, if a toolchain is present) native/libbcpnative.so
and returns None when unavailable — callers must keep the Python path.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbcpnative.so")

_lib = None
_load_attempted = False


def load() -> Optional[ctypes.CDLL]:
    """dlopen the native library, (re)building it first when a toolchain is
    present. Returns None (and remembers) when unavailable.

    The build always runs `make` (its dependency tracking makes a fresh
    .so a no-op, and skipping it would silently keep loading a stale binary
    after bcp_native.cpp edits) under an flock — concurrent bcpd processes
    on a fresh checkout must not race the compiler or dlopen a half-written
    file (g++ writes -o in place)."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("BCP_NO_NATIVE"):
        return None
    if os.path.isdir(_NATIVE_DIR) and os.access(_NATIVE_DIR, os.W_OK):
        try:
            import fcntl

            with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                subprocess.run(["make", "-C", _NATIVE_DIR],
                               capture_output=True, timeout=120, check=True)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None  # no toolchain and no prebuilt library
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _bind(lib)
    except (OSError, AttributeError):
        # missing library, or a stale prebuilt .so lacking newer symbols
        # (build skipped/failed): honor the "None when unavailable"
        # contract — callers keep the Python path
        return None
    _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bcp_engine_new.argtypes = []
    lib.bcp_engine_new.restype = ctypes.c_void_p
    lib.bcp_engine_free.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_free.restype = None
    lib.bcp_engine_set_best.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bcp_engine_set_best.restype = None
    lib.bcp_engine_get_best.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bcp_engine_get_best.restype = None
    lib.bcp_engine_mem_bytes.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_mem_bytes.restype = ctypes.c_uint64
    lib.bcp_engine_entries.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_entries.restype = ctypes.c_long
    lib.bcp_engine_insert.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.bcp_engine_insert.restype = None
    lib.bcp_engine_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.bcp_engine_get.restype = ctypes.c_int
    lib.bcp_engine_error.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.bcp_engine_error.restype = ctypes.c_long
    lib.bcp_engine_missing.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)
    ]
    lib.bcp_engine_missing.restype = u8p
    lib.bcp_engine_undo.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    ]
    lib.bcp_engine_undo.restype = u8p
    for name in ("bcp_engine_n_tx", "bcp_engine_n_inputs"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_long
    for name, rt in (
        ("bcp_engine_txids", u8p),
        ("bcp_engine_tx_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("bcp_engine_tx_out_counts", ctypes.POINTER(ctypes.c_uint32)),
        ("bcp_engine_spent_values", ctypes.POINTER(ctypes.c_int64)),
        ("bcp_engine_spent_heightcodes", ctypes.POINTER(ctypes.c_uint32)),
        ("bcp_engine_spent_spk_offsets", ctypes.POINTER(ctypes.c_uint32)),
        ("bcp_engine_sig_status", u8p),
        ("bcp_engine_sig_msg", u8p),
        ("bcp_engine_sig_rs", u8p),
        ("bcp_engine_sig_pub", u8p),
        ("bcp_engine_sig_rn", u8p),
        ("bcp_engine_sig_wrap", u8p),
        ("bcp_engine_sig_txin", ctypes.POINTER(ctypes.c_uint32)),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = rt
    lib.bcp_engine_spent_spk_blob.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    ]
    lib.bcp_engine_spent_spk_blob.restype = u8p
    lib.bcp_engine_connect_block.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.bcp_engine_connect_block.restype = ctypes.c_long
    lib.bcp_engine_commit.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_commit.restype = None
    lib.bcp_engine_sigscan_ns.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_sigscan_ns.restype = ctypes.c_uint64
    lib.bcp_engine_abort.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_abort.restype = None
    lib.bcp_engine_flush.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.bcp_engine_flush.restype = u8p
    lib.bcp_engine_clear.argtypes = [ctypes.c_void_p]
    lib.bcp_engine_clear.restype = None
    lib.bcp_sha256d.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                ctypes.c_char_p]
    lib.bcp_sha256d.restype = None
    lib.bcp_hash_headers.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_char_p]
    lib.bcp_hash_headers.restype = None
    lib.bcp_scan_block.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_long]
    lib.bcp_scan_block.restype = ctypes.c_long
    lib.bcp_merkle_root.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.c_char_p]
    lib.bcp_merkle_root.restype = ctypes.c_long
    lib.bcp_ecdsa_verify.argtypes = [ctypes.c_char_p] * 3
    lib.bcp_ecdsa_verify.restype = ctypes.c_int
    lib.bcp_ecdsa_verify_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bcp_ecdsa_verify_batch.restype = None
    lib.bcp_ecdsa_precompute.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bcp_ecdsa_precompute.restype = None
    lib.bcp_ecdsa_sign.argtypes = [ctypes.c_char_p] * 4
    lib.bcp_ecdsa_sign.restype = ctypes.c_int
    lib.bcp_pubkey_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_char_p]
    lib.bcp_pubkey_parse.restype = ctypes.c_int


def available() -> bool:
    return load() is not None


def sha256d(data: bytes) -> bytes:
    lib = load()
    assert lib is not None, "native library unavailable"
    out = ctypes.create_string_buffer(32)
    lib.bcp_sha256d(data, len(data), out)
    return out.raw


def hash_headers(headers: bytes) -> list[bytes]:
    """n concatenated 80-byte headers -> n sha256d digests."""
    assert len(headers) % 80 == 0
    n = len(headers) // 80
    lib = load()
    assert lib is not None, "native library unavailable"
    out = ctypes.create_string_buffer(32 * n)
    lib.bcp_hash_headers(headers, n, out)
    raw = out.raw  # ONE copy: .raw copies the whole buffer per access
    return [raw[32 * i:32 * i + 32] for i in range(n)]


class BlockScan:
    __slots__ = ("txids", "offsets")

    def __init__(self, txids: list[bytes], offsets: list[tuple[int, int]]):
        self.txids = txids
        self.offsets = offsets


def scan_block(raw: bytes, max_tx: int = 100_000) -> Optional[BlockScan]:
    """Wire-scan a serialized block: per-tx txids + [start, end) offsets.
    None on truncated/corrupt input (callers fall back to the Python
    deserializer, which raises the detailed error)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    # a serialized tx is >= ~10 bytes: size the buffers by the input, not
    # the worst case (txindex backfill calls this once per block)
    max_tx = min(max_tx, len(raw) // 10 + 1)
    txids = ctypes.create_string_buffer(32 * max_tx)
    offsets = (ctypes.c_uint64 * (2 * max_tx))()
    n = lib.bcp_scan_block(raw, len(raw), txids, offsets, max_tx)
    if n < 0:
        return None
    raw_txids = txids.raw  # ONE copy (see hash_headers)
    return BlockScan(
        [raw_txids[32 * i:32 * i + 32] for i in range(n)],
        [(int(offsets[2 * i]), int(offsets[2 * i + 1])) for i in range(n)],
    )


# Thread budget for batch entry points. 0 = one thread per core (the C++
# side resolves it); node init assigns this from -par (node/node.py).
PAR_THREADS = 0


def _pack_rs_msg(records) -> tuple[bytes, bytes]:
    """(r||s, msg_hash) blobs for the batch entry points (32-byte
    big-endian fields, mod 2^256 — the C side range-rejects r/s >= n)."""
    rs = b"".join(
        (rec.r % (1 << 256)).to_bytes(32, "big")
        + (rec.s % (1 << 256)).to_bytes(32, "big")
        for rec in records
    )
    msg = b"".join(
        (rec.msg_hash % (1 << 256)).to_bytes(32, "big") for rec in records
    )
    return rs, msg


def ecdsa_verify(pubkey: tuple, r: int, s: int, e: int) -> bool:
    """Scalar ECDSA verify on the native module (same acceptance set as
    crypto/secp256k1.ecdsa_verify — differentially tested). The pubkey is
    an affine (x, y) pair as produced by pubkey_parse."""
    lib = load()
    assert lib is not None, "native library unavailable"
    pub = pubkey[0].to_bytes(32, "big") + pubkey[1].to_bytes(32, "big")
    rs = (r % (1 << 256)).to_bytes(32, "big") + \
        (s % (1 << 256)).to_bytes(32, "big")
    msg = (e % (1 << 256)).to_bytes(32, "big")
    return bool(lib.bcp_ecdsa_verify(pub, rs, msg))


def ecdsa_verify_batch(records, nthreads: int | None = None) -> list[bool]:
    """Batch verify SigCheckRecord-shaped objects (.pubkey/.r/.s/.msg_hash)
    across host threads — the CPU fallback lane of ops/ecdsa_batch."""
    lib = load()
    assert lib is not None, "native library unavailable"
    n = len(records)
    if n == 0:
        return []
    pub = b"".join(
        rec.pubkey[0].to_bytes(32, "big") + rec.pubkey[1].to_bytes(32, "big")
        for rec in records
    )
    rs, msg = _pack_rs_msg(records)
    ok = ctypes.create_string_buffer(n)
    lib.bcp_ecdsa_verify_batch(pub, rs, msg, n, ok,
                               nthreads if nthreads is not None
                               else PAR_THREADS)
    return [b == 1 for b in ok.raw]


def ecdsa_precompute(records, nthreads: int | None = None):
    """Per-record u1 = e*s^-1 mod n, u2 = r*s^-1 mod n as two n*32-byte
    big-endian blobs (+ per-record validity flags) — the host scalar leg of
    the TPU batch packer, replacing the Python-int pow() loop."""
    lib = load()
    assert lib is not None, "native library unavailable"
    n = len(records)
    if n == 0:
        return b"", b"", []
    rs, msg = _pack_rs_msg(records)
    u1 = ctypes.create_string_buffer(32 * n)
    u2 = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    lib.bcp_ecdsa_precompute(rs, msg, n, u1, u2, ok,
                             nthreads if nthreads is not None
                             else PAR_THREADS)
    return u1.raw, u2.raw, [b == 1 for b in ok.raw]


def pubkey_parse(data: bytes):
    """CPubKey parse/decompress (same acceptance as the oracle's
    pubkey_parse — compressed sqrt, uncompressed/hybrid on-curve checks).
    Returns affine (x, y) or None. ~30x the Python path for compressed
    keys (the modular sqrt dominates)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    out = ctypes.create_string_buffer(64)
    if not lib.bcp_pubkey_parse(data, len(data), out):
        return None
    return (int.from_bytes(out.raw[:32], "big"),
            int.from_bytes(out.raw[32:], "big"))


def ecdsa_sign(secret: int, e: int) -> tuple[int, int]:
    """RFC6979-deterministic ECDSA sign, bit-identical to the oracle signer
    (crypto/secp256k1.ecdsa_sign): the nonce derivation runs in Python
    (HMAC — microseconds), the EC math runs native (~100x the Python-int
    point_mul). Low-s normalized."""
    from .crypto.secp256k1 import N, rfc6979_nonce

    lib = load()
    assert lib is not None, "native library unavailable"
    sk = secret.to_bytes(32, "big")
    eb = (e % (1 << 256)).to_bytes(32, "big")
    out = ctypes.create_string_buffer(64)
    k = rfc6979_nonce(secret, e)
    extra = 0
    while not lib.bcp_ecdsa_sign(sk, eb, k.to_bytes(32, "big"), out):
        # r == 0 / s == 0 (cryptographically unreachable): next candidate
        # nonce, same retry semantics as the oracle's while-loop
        extra += 1
        k = rfc6979_nonce(secret, e, extra.to_bytes(4, "big"))
        assert 1 <= k < N
    return (int.from_bytes(out.raw[:32], "big"),
            int.from_bytes(out.raw[32:], "big"))


def merkle_root(txids: list[bytes]) -> tuple[bytes, bool]:
    """(root, mutated) — ComputeMerkleRoot with the CVE-2012-2459 flag."""
    lib = load()
    assert lib is not None, "native library unavailable"
    n = len(txids)
    if n == 0:
        return b"\x00" * 32, False
    buf = b"".join(txids)
    out = ctypes.create_string_buffer(32)
    mutated = lib.bcp_merkle_root(buf, n, out)
    return out.raw, bool(mutated)


# ---------------------------------------------------------------------------
# Block-connect engine (native/connect.cpp) — the C++ ConnectBlock hot path
# for -reindex. Reference: src/validation.cpp LoadExternalBlockFile/
# ConnectBlock, src/coins.cpp. Semantics mirror validation/chainstate.py;
# differential tests: tests/unit/test_native_connect.py.
# ---------------------------------------------------------------------------

# engine error code -> (reject reason, is_script_error) matching the Python
# path's BlockValidationError reasons / ScriptError codes
ENGINE_ERRORS = {
    -1: "deserialize",
    -2: "bad-txnmrklroot",
    -3: "bad-txns-duplicate",
    -4: "bad-blk-length",
    -5: "bad-blk-length",
    -6: "bad-cb-missing",
    -7: "bad-cb-multiple",
    -8: "bad-txns-vin-empty",
    -9: "bad-txns-vout-empty",
    -10: "bad-txns-oversize",
    -11: "bad-txns-vout-negative",
    -12: "bad-txns-vout-toolarge",
    -13: "bad-txns-txouttotal-toolarge",
    -14: "bad-txns-inputs-duplicate",
    -15: "bad-cb-length",
    -16: "bad-txns-prevout-null",
    -17: "bad-txns-nonfinal",
    -18: "bad-cb-height",
    -19: "bad-txns-BIP30",
    -20: "bad-txns-inputs-missingorspent",
    -21: "bad-txns-premature-spend-of-coinbase",
    -22: "bad-txns-inputvalues-outofrange",
    -23: "bad-txns-in-belowout",
    -24: "bad-txns-fee-outofrange",
    -25: "bad-cb-amount",
    # script errors (block-fatal, ScriptError codes)
    -101: "equalverify",
    -102: "sig-der",
    -103: "sig-high-s",
    -104: "sig-hashtype",
    -105: "illegal-forkid",
    -106: "must-use-forkid",
    -107: "pubkeytype",
    -108: "sig-nullfail",
    -109: "eval-false",
}


class NativeConnectResult:
    """Successful native connect: everything the Python orchestration layer
    needs, copied out of the engine's scratch buffers (which the next engine
    call reuses). Sig arrays are numpy for vectorized compaction."""

    __slots__ = ("block_hash", "n_tx", "n_inputs", "undo", "txids_blob",
                 "sigscan_s",
                 "tx_offsets", "tx_out_counts", "sig_status", "sig_msg",
                 "sig_rs", "sig_pub", "sig_rn", "sig_wrap", "sig_txin",
                 "spent_values", "spent_heightcodes", "spent_spk_offsets",
                 "spent_spk_blob")

    def txid(self, i: int) -> bytes:
        return self.txids_blob[32 * i:32 * i + 32]

    def txids(self) -> list[bytes]:
        blob = self.txids_blob
        return [blob[32 * i:32 * i + 32] for i in range(self.n_tx)]


class EngineMissing(Exception):
    """Connect needs prevouts not in the engine map; .keys are the 36-byte
    outpoint keys to fetch from the base store and insert."""

    def __init__(self, keys: list[bytes]):
        super().__init__(f"{len(keys)} prevouts not cached")
        self.keys = keys


class EngineError(Exception):
    """Native validation verdict (advisory: the import path re-runs the
    block through the Python engine for the authoritative error)."""

    def __init__(self, reason: str, tx_idx: int, in_idx: int,
                 is_script: bool):
        super().__init__(f"{reason} (tx {tx_idx} input {in_idx})")
        self.reason = reason
        self.tx_idx = tx_idx
        self.in_idx = in_idx
        self.is_script = is_script


def _np():
    import numpy

    return numpy


class ConnectEngine:
    """The in-memory UTXO cache + block-connect engine (CCoinsViewCache +
    ConnectBlock in C++). One instance per import session; NOT thread-safe
    (the import loop is single-threaded; the engine threads internally)."""

    def __init__(self):
        lib = load()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self._h = lib.bcp_engine_new()

    def close(self):
        if self._h:
            self._lib.bcp_engine_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass

    # -- coin cache ----------------------------------------------------

    def insert(self, key36: bytes, height_code: int, value: int,
               spk: bytes) -> None:
        self._lib.bcp_engine_insert(self._h, key36, height_code, value,
                                    spk, len(spk))

    def get(self, key36: bytes):
        """(height_code, value, spk) for a live coin; None if absent;
        the string "spent" for a tombstone."""
        hc = ctypes.c_uint32()
        val = ctypes.c_int64()
        spk = ctypes.POINTER(ctypes.c_uint8)()
        spk_len = ctypes.c_uint32()
        rc = self._lib.bcp_engine_get(
            self._h, key36, ctypes.byref(hc), ctypes.byref(val),
            ctypes.byref(spk), ctypes.byref(spk_len))
        if rc == 0:
            return None
        if rc == -1:
            return "spent"
        return (hc.value, val.value,
                ctypes.string_at(spk, spk_len.value))

    def mem_bytes(self) -> int:
        return self._lib.bcp_engine_mem_bytes(self._h)

    def entries(self) -> int:
        return self._lib.bcp_engine_entries(self._h)

    def set_best(self, h32: bytes) -> None:
        self._lib.bcp_engine_set_best(self._h, h32)

    def best(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.bcp_engine_get_best(self._h, out)
        return out.raw

    # -- connect -------------------------------------------------------

    def connect_block(self, raw: bytes, height: int, subsidy: int,
                      max_block_size: int, coinbase_maturity: int,
                      mtp: int, bip34_prefix: bytes | None,
                      script_flags: int, want_sigs: bool,
                      check_merkle: bool = True, nthreads: int = 0,
                      commit: bool = True) -> NativeConnectResult:
        """Validate + (optionally) apply one block. commit=False stages the
        UTXO edits; call commit()/abort() after the caller's own script
        checks settle — the Python fallback interpreter runs in between."""
        lib = self._lib
        hash_out = ctypes.create_string_buffer(32)
        rc = lib.bcp_engine_connect_block(
            self._h, raw, len(raw), height, subsidy, max_block_size,
            coinbase_maturity, mtp,
            bip34_prefix if bip34_prefix else None,
            len(bip34_prefix) if bip34_prefix else 0,
            script_flags, 1 if want_sigs else 0,
            1 if check_merkle else 0, nthreads,
            1 if commit else 0, hash_out)
        if rc == 1:
            n = ctypes.c_long()
            ptr = lib.bcp_engine_missing(self._h, ctypes.byref(n))
            blob = ctypes.string_at(ptr, 36 * n.value)
            raise EngineMissing(
                [blob[36 * i:36 * i + 36] for i in range(n.value)])
        if rc < 0:
            t = ctypes.c_long()
            i = ctypes.c_long()
            code = lib.bcp_engine_error(self._h, ctypes.byref(t),
                                        ctypes.byref(i))
            raise EngineError(ENGINE_ERRORS.get(code, f"native-{code}"),
                              t.value, i.value, code <= -100)
        np = _np()
        res = NativeConnectResult()
        res.block_hash = hash_out.raw
        res.sigscan_s = lib.bcp_engine_sigscan_ns(self._h) / 1e9
        res.n_tx = lib.bcp_engine_n_tx(self._h)
        res.n_inputs = lib.bcp_engine_n_inputs(self._h)
        ulen = ctypes.c_size_t()
        uptr = lib.bcp_engine_undo(self._h, ctypes.byref(ulen))
        res.undo = ctypes.string_at(uptr, ulen.value)
        res.txids_blob = ctypes.string_at(lib.bcp_engine_txids(self._h),
                                          32 * res.n_tx)
        res.tx_offsets = np.frombuffer(
            ctypes.string_at(lib.bcp_engine_tx_offsets(self._h),
                             16 * res.n_tx), np.uint64).reshape(res.n_tx, 2)
        res.tx_out_counts = np.frombuffer(
            ctypes.string_at(lib.bcp_engine_tx_out_counts(self._h),
                             4 * res.n_tx), np.uint32)
        n = res.n_inputs
        if n:
            res.sig_status = np.frombuffer(
                ctypes.string_at(lib.bcp_engine_sig_status(self._h), n),
                np.uint8)
            res.sig_txin = np.frombuffer(
                ctypes.string_at(lib.bcp_engine_sig_txin(self._h), 8 * n),
                np.uint32).reshape(n, 2)
            if want_sigs:
                res.sig_msg = np.frombuffer(
                    ctypes.string_at(lib.bcp_engine_sig_msg(self._h),
                                     32 * n), np.uint8).reshape(n, 32)
                res.sig_rs = np.frombuffer(
                    ctypes.string_at(lib.bcp_engine_sig_rs(self._h),
                                     64 * n), np.uint8).reshape(n, 64)
                res.sig_pub = np.frombuffer(
                    ctypes.string_at(lib.bcp_engine_sig_pub(self._h),
                                     64 * n), np.uint8).reshape(n, 64)
                res.sig_rn = np.frombuffer(
                    ctypes.string_at(lib.bcp_engine_sig_rn(self._h),
                                     32 * n), np.uint8).reshape(n, 32)
                res.sig_wrap = np.frombuffer(
                    ctypes.string_at(lib.bcp_engine_sig_wrap(self._h), n),
                    np.uint8)
            res.spent_values = np.frombuffer(
                ctypes.string_at(lib.bcp_engine_spent_values(self._h),
                                 8 * n), np.int64)
            res.spent_heightcodes = np.frombuffer(
                ctypes.string_at(lib.bcp_engine_spent_heightcodes(self._h),
                                 4 * n), np.uint32)
            res.spent_spk_offsets = np.frombuffer(
                ctypes.string_at(lib.bcp_engine_spent_spk_offsets(self._h),
                                 4 * (n + 1)), np.uint32)
            slen = ctypes.c_size_t()
            sptr = lib.bcp_engine_spent_spk_blob(self._h,
                                                 ctypes.byref(slen))
            res.spent_spk_blob = ctypes.string_at(sptr, slen.value)
        return res

    def commit(self) -> None:
        """Apply a connect_block(commit=False) staging."""
        self._lib.bcp_engine_commit(self._h)

    def abort(self) -> None:
        """Discard a connect_block(commit=False) staging."""
        self._lib.bcp_engine_abort(self._h)

    # -- flush ---------------------------------------------------------

    def flush_entries(self):
        """Yield (key36, coin_serialization | None-for-delete) for every
        dirty entry; the caller writes the CoinsDB batch then calls
        clear(). Entry format documented at bcp_engine_flush."""
        ln = ctypes.c_size_t()
        n = ctypes.c_long()
        ptr = self._lib.bcp_engine_flush(self._h, ctypes.byref(ln),
                                         ctypes.byref(n))
        blob = ctypes.string_at(ptr, ln.value)
        out = []
        pos = 0
        for _ in range(n.value):
            key = blob[pos:pos + 36]
            tag = blob[pos + 36]
            pos += 37
            if tag == 0:
                out.append((key, None))
            else:
                (clen,) = struct.unpack_from("<I", blob, pos)
                pos += 4
                out.append((key, blob[pos:pos + clen]))
                pos += clen
        return out

    def clear(self) -> None:
        self._lib.bcp_engine_clear(self._h)


def engine_available() -> bool:
    """True when the connect engine's symbols are present (a stale prebuilt
    .so without them makes load() return None already)."""
    lib = load()
    return lib is not None and hasattr(lib, "bcp_engine_new")


# -- blob-level ECDSA batch entries (the native sigscan's outputs feed these
# directly — no per-record Python int round trip) ---------------------------

def ecdsa_precompute_blobs(rs: bytes, msg: bytes, n: int,
                           nthreads: int | None = None):
    """u1/u2 blobs + validity flags from raw (r||s, msg) blobs — the blob
    form of ecdsa_precompute (same C entry point)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    if n == 0:
        return b"", b"", []
    u1 = ctypes.create_string_buffer(32 * n)
    u2 = ctypes.create_string_buffer(32 * n)
    ok = ctypes.create_string_buffer(n)
    lib.bcp_ecdsa_precompute(rs, msg, n, u1, u2, ok,
                             nthreads if nthreads is not None
                             else PAR_THREADS)
    return u1.raw, u2.raw, [b == 1 for b in ok.raw]


def ecdsa_verify_batch_blobs(pub: bytes, rs: bytes, msg: bytes, n: int,
                             nthreads: int | None = None) -> list[bool]:
    """Blob form of ecdsa_verify_batch (threaded native scalar verify)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    if n == 0:
        return []
    ok = ctypes.create_string_buffer(n)
    lib.bcp_ecdsa_verify_batch(pub, rs, msg, n, ok,
                               nthreads if nthreads is not None
                               else PAR_THREADS)
    return [b == 1 for b in ok.raw]
