"""Signature-dense regtest chain generator — the port's block-validation
workload.

The logic of the reference's tools/gen_sigchain.py (uniform segment),
built on the port's own modules: a coinbase runway, fan-out transactions
splitting mature coinbases into many P2PKH outputs, then dense blocks of
many-input P2PKH spends — every input one ECDSA signature, or, with
``schnorr=True``, one 65-byte BCH Schnorr signature (the 64 bytes of
``crypto/secp256k1.schnorr_sign`` over the input's forkid sighash, then
the hashtype byte; the runway and fan-out stay ECDSA, so a dispatch
mixes both). Blocks go
through the port's BlockStore (blk?????.dat with netmagic framing), so a
reader walks them exactly as the node's block-file import does.
Generation skips script verification (script_verifier=None): blocks are
valid by construction, and the validation run IS the check.

Besides the chain it builds two competing blocks on top of the tip, each
spending ``tip_inputs`` dense outputs (the shape of a small block handed
to submitblock): a good one, and one with a signature altered inside its
DER s-value (a Schnorr chain: a byte inside one signature's s) — the
encodings stay valid, so that block can only fail at signature
verification. Both are returned serialized and are not stored.

CLI:  python -m bitcoincashplus_tpu_torch.workload.sigchain --datadir D
      --sigs 16000 [--schnorr]
Emits one JSON line: {"blocks": N, "txs": N, "sigs": N, "bytes": N, ...}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import time

from ..consensus.block import CBlock, CBlockHeader
from ..consensus.merkle import block_merkle_root
from ..consensus.params import get_block_subsidy, regtest_params
from ..consensus.pow import compact_to_target
from ..consensus.tx import COutPoint, CTransaction, CTxIn, CTxOut
from ..crypto import secp256k1 as oracle
from ..crypto.hashes import sha256d
from ..store.blockstore import BlockStore, MemoryBlockStore
from ..store.chainstatedb import BlockIndexDB, CoinsDB
from ..store.kvstore import KVStore
from ..validation.chainstate import ChainstateManager, _script_int
from ..validation.coins import MemoryCoinsView
from ..script.interpreter import DeferringSignatureChecker, VerifyScript
from ..script.script import push_data_raw
from ..script.sighash import (SIGHASH_ALL, SIGHASH_FORKID, SighashCache,
                              signature_hash)
from ..validation.scriptcheck import BlockScriptVerifier, block_script_flags
from ..wallet.keys import CKey
from ..wallet.signing import sign_transaction

FEE = 10_000  # flat per-tx fee (sat) — keeps every output above dust
KEY_SECRET = 0x53C5A1F4E0B1DE5FCE


def bip34_coinbase_script_sig(height: int, extranonce: int = 0) -> bytes:
    """Height push (BIP34) + extranonce push (the reference's
    mining/assembler.bip34_coinbase_script_sig)."""
    tail = _script_int(extranonce) if extranonce > 0 else b""
    sig = _script_int(height) + tail
    if len(sig) < 2:  # bad-cb-length lower bound
        sig += b"\x00"
    return sig


def _mine(header: CBlockHeader, target: int) -> CBlockHeader:
    """Regtest difficulty-1 PoW: a couple of nonce tries on average."""
    nonce = 0
    raw = bytearray(header.serialize())
    while True:
        struct.pack_into("<I", raw, 76, nonce)
        if int.from_bytes(sha256d(bytes(raw)), "little") <= target:
            return header.with_nonce(nonce)
        nonce += 1


def _make_block(prev_hash: bytes, height: int, block_time: int, bits: int,
                target: int, txs: tuple, spk: bytes) -> CBlock:
    fees = FEE * len(txs)
    coinbase = CTransaction(
        version=1,
        vin=(CTxIn(COutPoint(),
                   bip34_coinbase_script_sig(height) + b"sigchain",
                   0xFFFFFFFF),),
        vout=(CTxOut(fees + get_block_subsidy(height,
                                              regtest_params().consensus),
                     spk),),
    )
    vtx = (coinbase, *txs)

    class _V:
        pass

    v = _V()
    v.vtx = vtx
    root, _ = block_merkle_root(v)
    header = CBlockHeader(
        version=0x20000000, hash_prev_block=prev_hash, hash_merkle_root=root,
        time=block_time, bits=bits, nonce=0,
    )
    return CBlock(_mine(header, target), vtx)


# G's fixed-base comb for the Schnorr signer: row i holds j 256^i G,
# j = 1 .. 255 (affine; index 0 unused), built once per process
_G_COMB: list = []


def _g_comb() -> list:
    if not _G_COMB:
        base = oracle.G
        for _ in range(32):
            row = [None, base]
            for _j in range(2, 256):
                row.append(oracle.point_add(row[-1], base))
            _G_COMB.append(row)
            base = oracle.point_add(row[-1], base)  # 256 base
    return _G_COMB


def _jac_add_affine(acc, q):
    """Jacobian acc (None = infinity) + affine q, Python ints mod p."""
    if acc is None:
        return (q[0], q[1], 1)
    P = oracle.P
    X, Y, Z = acc
    zz = Z * Z % P
    H = (q[0] * zz - X) % P
    R = (q[1] * zz * Z - Y) % P
    if H == 0:
        if R == 0:  # acc == q: double q
            x3, y3 = oracle.point_double(q)
            return (x3, y3, 1)
        return None
    HH = H * H % P
    HHH = H * HH % P
    V = X * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return (X3, (R * (V - X3) - Y * HHH) % P, Z * H % P)


class SchnorrSigner:
    """``crypto/secp256k1.schnorr_sign(secret, e)`` for one key, with the
    same RFC6979 nonce, the same R and the same (r, s), at a fraction of
    its cost: k G from the fixed-base comb in Jacobian coordinates (one
    inversion), and the public key computed once."""

    def __init__(self, secret: int):
        self.secret = secret
        self.pub = oracle.point_mul(secret, oracle.G)
        self.comb = _g_comb()

    def sign(self, e: int) -> tuple:
        k = oracle.rfc6979_nonce(self.secret, e, extra=b"Schnorr+SHA256  ")
        acc = None
        for i, d in enumerate(k.to_bytes(32, "little")):
            if d:
                acc = _jac_add_affine(acc, self.comb[i][d])
        X, Y, Z = acc
        zi = pow(Z, oracle.P - 2, oracle.P)
        ry = Y * zi * zi * zi % oracle.P
        if oracle.jacobi(ry) != 1:
            k = oracle.N - k
        r = X * zi * zi % oracle.P
        e2 = oracle.schnorr_challenge(r, self.pub, e)
        return r, (k + e2 * self.secret) % oracle.N


SCHNORR_HASHTYPE = SIGHASH_ALL | SIGHASH_FORKID


def sign_schnorr_p2pkh(tx: CTransaction, amounts: list, key: CKey,
                       signer: SchnorrSigner) -> CTransaction:
    """Sign every input of ``tx`` (each spending ``key``'s P2PKH output of
    the given amount) with a 65-byte Schnorr signature:
    push(r || s || hashtype) push(pubkey)."""
    spk = key.p2pkh_script()
    cache = SighashCache(tx)
    vin = []
    for i, (txin, amount) in enumerate(zip(tx.vin, amounts)):
        digest = signature_hash(spk, tx, i, SCHNORR_HASHTYPE, amount,
                                enable_forkid=True, cache=cache)
        r, s = signer.sign(int.from_bytes(digest, "big"))
        sig = (r.to_bytes(32, "big") + s.to_bytes(32, "big")
               + bytes([SCHNORR_HASHTYPE]))
        vin.append(CTxIn(txin.prevout,
                         push_data_raw(sig) + push_data_raw(key.pubkey),
                         txin.sequence))
    return CTransaction(tx.version, tuple(vin), tx.vout, tx.locktime)


def _tamper_input(tx: CTransaction, i: int) -> CTransaction:
    """Flip one bit in the middle of input i's s-value (P2PKH scriptSig:
    push(sig || hashtype) push(pubkey)): inside the DER s, or, for a
    65-byte Schnorr signature, inside its 32-byte s."""
    ss = bytearray(tx.vin[i].script_sig)
    sig = ss[1:1 + ss[0]]
    if len(sig) == 65:
        ss[1 + 32 + 16] ^= 0x01
    else:
        rlen = sig[3]
        s_off = 1 + 4 + rlen + 2  # scriptSig offset of the first s byte
        slen = sig[4 + rlen + 1]
        ss[s_off + slen // 2] ^= 0x01
    vin = list(tx.vin)
    vin[i] = CTxIn(vin[i].prevout, bytes(ss), vin[i].sequence)
    return CTransaction(tx.version, tuple(vin), tx.vout, tx.locktime)


def generate(datadir: str, total_sigs: int, inputs_per_tx: int = 250,
             txs_per_block: int = 8, fan_k: int = 2000,
             tip_inputs: int = 32, progress=lambda s: None,
             schnorr: bool = False) -> dict:
    """Write the chain into ``datadir`` (regtest layout) and return its
    summary; ``summary["tampered_tip"]`` and ``summary["good_tip"]`` are
    the serialized competing tips. ``schnorr``: the dense spends and both
    tips carry Schnorr signatures."""
    params = regtest_params()
    net_dir = os.path.join(datadir, "regtest")
    blocks_dir = os.path.join(net_dir, "blocks")
    os.makedirs(blocks_dir, exist_ok=True)

    index_kv = KVStore(os.path.join(blocks_dir, "index.sqlite"))
    coins_kv = KVStore(os.path.join(net_dir, "chainstate.sqlite"))
    store = BlockStore(net_dir, params.netmagic)
    cs = ChainstateManager(
        params, CoinsDB(coins_kv), store, script_verifier=None,
        index_db=BlockIndexDB(index_kv),
    )

    key = CKey(KEY_SECRET, compressed=True)
    spk = key.p2pkh_script()
    signer = SchnorrSigner(KEY_SECRET) if schnorr else None

    def key_for_id(ident):
        return key if ident in (key.pubkey_hash, key.pubkey) else None

    bits = params.genesis.header.bits
    target, _ = compact_to_target(bits)
    t = [params.genesis.header.time]
    n_blocks = [0]
    n_txs = [0]
    n_bytes = [0]

    def next_block(txs=()):
        tip = cs.tip()
        t[0] += 60
        return _make_block(tip.hash, tip.height + 1, t[0], bits, target,
                           tuple(txs), spk)

    def push(txs=()):
        blk = next_block(txs)
        cs.process_new_block(blk)
        n_blocks[0] += 1
        n_txs[0] += len(blk.vtx)
        n_bytes[0] += len(blk.serialize())
        return blk

    def spend(chunk):
        total_in = sum(v for _, _, v in chunk)
        unsigned = CTransaction(
            version=1,
            vin=tuple(CTxIn(COutPoint(txid, i), b"", 0xFFFFFFFE)
                      for txid, i, _ in chunk),
            vout=(CTxOut(total_in - FEE, spk),),
        )
        if signer is not None:
            return sign_schnorr_p2pkh(unsigned, [v for _, _, v in chunk],
                                      key, signer)
        return sign_transaction(unsigned, [(spk, v) for _, _, v in chunk],
                                key_for_id, enable_forkid=True)

    # Phase 1: coinbase runway. Fan-out txs each consume one MATURE (100+
    # deep) coinbase, so mint enough and add the maturity padding.
    n_fan = (total_sigs + fan_k - 1) // fan_k
    runway = n_fan + 100
    progress(f"runway: {runway} coinbase blocks")
    coinbases = []
    for _ in range(runway):
        blk = push()
        coinbases.append((blk.vtx[0].txid, blk.vtx[0].vout[0].value))
    coinbases = coinbases[:n_fan]

    # Phase 2: fan-out — split each mature coinbase into fan_k outputs.
    progress(f"fan-out: {n_fan} txs x {fan_k} outputs")
    utxos = []
    fan_batch = []
    for txid, value in coinbases:
        per_out = (value - FEE) // fan_k
        if per_out <= 546:
            raise ValueError("fan_k too large for the subsidy")
        unsigned = CTransaction(
            version=1,
            vin=(CTxIn(COutPoint(txid, 0), b"", 0xFFFFFFFE),),
            vout=tuple(CTxOut(per_out, spk) for _ in range(fan_k)),
        )
        signed = sign_transaction(unsigned, [(spk, value)], key_for_id,
                                  enable_forkid=True)
        fan_batch.append(signed)
        utxos.extend((signed.txid, i, per_out) for i in range(fan_k))
        if len(fan_batch) == 5:
            push(fan_batch)
            fan_batch = []
    if fan_batch:
        push(fan_batch)

    # Phase 3: dense blocks of txs_per_block txs x inputs_per_tx spends.
    utxos = utxos[:total_sigs]
    progress(f"dense: {len(utxos)} sig-inputs")
    dense_outs = []
    pos = 0
    while pos < len(utxos):
        txs = []
        for _ in range(txs_per_block):
            chunk = utxos[pos:pos + inputs_per_tx]
            if not chunk:
                break
            pos += len(chunk)
            txs.append(spend(chunk))
            dense_outs.append((txs[-1].txid, 0, txs[-1].vout[0].value))
        push(txs)
        progress(f"dense block {n_blocks[0]}: {pos}/{len(utxos)} sigs")

    # two competing tips, not stored: the tampered one spends the first
    # tip_inputs dense outputs with one s-value altered, the good one the
    # next tip_inputs
    if len(dense_outs) < 2 * tip_inputs:
        raise ValueError(f"{len(dense_outs)} dense outputs; the tips need "
                         f"{2 * tip_inputs}")
    bad = spend(dense_outs[:tip_inputs])
    bad = _tamper_input(bad, len(bad.vin) // 2)
    tampered = next_block((bad,))
    good = next_block((spend(dense_outs[tip_inputs:2 * tip_inputs]),))

    store.flush()
    cs.flush()
    store.close()
    index_kv.close()
    coins_kv.close()
    return {
        "blocks": n_blocks[0],
        "txs": n_txs[0],
        "sigs": len(utxos),
        "bytes": n_bytes[0],
        "tip_height": n_blocks[0],
        "tampered_tip": tampered.serialize(),
        "good_tip": good.serialize(),
        "tip_sigs": tip_inputs,
    }


def read_blocks(datadir: str):
    """Yield the chain's blocks in file order from its blk?????.dat files
    (netmagic + size framing), as the node's block-file import reads
    them."""
    params = regtest_params()
    blocks_dir = os.path.join(datadir, "regtest", "blocks")
    n_file = 0
    while True:
        path = os.path.join(blocks_dir, f"blk{n_file:05d}.dat")
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 8 <= len(data):
            if data[pos:pos + 4] != params.netmagic:
                raise ValueError(f"{path}: bad frame at {pos}")
            (size,) = struct.unpack_from("<I", data, pos + 4)
            start = pos + 8
            yield CBlock.from_bytes(data[start:start + size])
            pos = start + size
        n_file += 1


def chain_sig_records(datadir: str, limit: int) -> list:
    """The first ``limit`` signature checks of the stored chain, as the
    script interpreter defers them (SigCheckRecords), found by replaying
    every input's scripts against the outputs the chain itself created."""
    params = regtest_params()
    outs: dict = {}
    records: list = []
    for height, block in enumerate(read_blocks(datadir)):
        flags = block_script_flags(height, block.header.time, params)
        for tx in block.vtx:
            if not tx.is_coinbase():
                cache = SighashCache(tx)
                for i, txin in enumerate(tx.vin):
                    value, spk = outs.pop((txin.prevout.hash,
                                           txin.prevout.n))
                    checker = DeferringSignatureChecker(tx, i, value,
                                                        records, cache)
                    VerifyScript(txin.script_sig, spk, flags, checker)
                    if len(records) >= limit:
                        return records[:limit]
            for n, out in enumerate(tx.vout):
                outs[(tx.txid, n)] = (out.value, out.script_pubkey)
    return records


def coin_digest(cs: ChainstateManager) -> str:
    """Byte digest of the settled coin set over a MemoryCoinsView base
    (rows key-sorted) and the best block."""
    cs.coins.flush()
    h = hashlib.sha256()
    for op, coin in sorted(cs.coins.base._coins.items(),
                           key=lambda kv: (kv[0].hash, kv[0].n)):
        h.update(op.hash)
        h.update(op.n.to_bytes(4, "little"))
        h.update(coin.serialize())
    h.update(cs.coins.best_block())
    return h.hexdigest()


def validate_chain(datadir: str, backend: str, kernel: str | None = None,
                   depth: int = 8) -> tuple:
    """Validate the stored chain from scratch through a ChainstateManager
    with a BlockScriptVerifier(backend, kernel) (kernel None: the process
    default, -ecdsakernel=glv unless set otherwise) and the pipelined engine
    at ``depth`` — the shape of the node's block-file import loop (blocks
    in file order through process_new_block_pipelined, then the settle
    horizon drained). Returns (chainstate, summary)."""
    params = regtest_params()
    cs = ChainstateManager(
        params, MemoryCoinsView(), MemoryBlockStore(),
        script_verifier=BlockScriptVerifier(params, backend=backend,
                                            kernel=kernel))
    cs.pipeline_depth = depth
    t0 = time.monotonic()
    n = 0
    for block in read_blocks(datadir):
        cs.process_new_block_pipelined(block)
        n += 1
    cs.settle_horizon()
    cs.flush()
    wall = time.monotonic() - t0
    return cs, {"blocks": n, "height": cs.tip().height,
                "best": cs.tip().hash.hex(), "wall_s": wall,
                "digest": coin_digest(cs)}


def reindex(datadir: str, **flags) -> dict:
    """The node's -reindex of the chain in ``datadir``, in process:
    node/node.Node with -regtest -reindex and ``flags`` as -name=value
    (``tpu="0"``: the CPU engine; ``ecdsakernel="w4"``; ...), closed
    after. Returns its summary: height, best block (as validate_chain's),
    the coin set's muhash_digest(), the wall seconds from the node's start
    to its imported tip, and the engine that ran: "native" (the connect
    engine's packed signature batches, with its last_import_stats) or
    "python" (the import loop of the Python engine)."""
    from ..node.config import Config
    from ..node.node import Node

    cfg = Config()
    cfg.args.update(datadir=[datadir], regtest=["1"], reindex=["1"])
    for name, value in flags.items():
        cfg.args[name] = [str(value)]
    t0 = time.monotonic()
    node = Node(config=cfg)
    try:
        wall = time.monotonic() - t0
        tip = node.chainstate.tip()
        stats = node.last_import_stats
        return {"height": tip.height, "best": tip.hash.hex(),
                "muhash": node.coins_db.muhash_digest().hex(),
                "wall_s": wall, "engine": "native" if stats else "python",
                "import_stats": stats}
    finally:
        node.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--sigs", type=int, default=16_000)
    ap.add_argument("--inputs-per-tx", type=int, default=250)
    ap.add_argument("--txs-per-block", type=int, default=8)
    ap.add_argument("--fan-k", type=int, default=2000)
    ap.add_argument("--schnorr", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()
    progress = (lambda s: None) if args.quiet else (
        lambda s: print(f"[sigchain] {s}", file=sys.stderr, flush=True))
    summary = generate(args.datadir, args.sigs, args.inputs_per_tx,
                       args.txs_per_block, args.fan_k, progress=progress,
                       schnorr=args.schnorr)
    for k in ("tampered_tip", "good_tip"):
        summary[k] = summary[k].hex()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
