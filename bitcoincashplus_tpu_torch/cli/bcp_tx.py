"""bcp-tx — offline transaction builder/editor (src/bitcoin-tx.cpp).

Command-style arguments applied left to right to a transaction, like the
reference tool:

    bcp-tx [-regtest|-testnet] [-json] [-create | <hextx>] <command>...

Commands:
    nversion=N                    set tx version
    locktime=N                    set nLockTime
    in=TXID:VOUT[:SEQUENCE]       append an input (txid in display hex)
    out=AMOUNT:ADDRESS            append a P2PKH output (amount in coins)
    outscript=AMOUNT:HEXSCRIPT    append a raw-script output
    outdata=HEXDATA               append an OP_RETURN data output
    delin=N / delout=N            delete input/output N
    sign=WIF:TXID:VOUT:SPKHEX:AMOUNT
                                  sign one matching input (FORKID sighash)

Runs entirely offline — no node, no RPC, no device."""

from __future__ import annotations

import json
import sys

from ..consensus.params import select_params
from ..consensus.serialize import ByteReader, hash_to_hex, hex_to_hash
from ..consensus.tx import COIN, COutPoint, CTransaction, CTxIn, CTxOut
from ..script.script import OP_RETURN, push_data_raw
from ..script.sighash import SIGHASH_ALL, SIGHASH_FORKID
from ..wallet.keys import CKey, address_to_script
from ..wallet.signing import solve_script_sig


def _fail(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    network = "main"
    as_json = False
    while args and args[0].startswith("-") and args[0] != "-create":
        flag = args.pop(0)
        if flag == "-regtest":
            network = "regtest"
        elif flag == "-testnet":
            network = "test"
        elif flag == "-json":
            as_json = True
        elif flag in ("-h", "-help", "--help"):
            print(__doc__)
            return 0
        else:
            return _fail(f"unknown flag {flag}")
    params = select_params(network)
    if not args:
        print(__doc__)
        return 1

    first = args.pop(0)
    if first == "-create":
        tx = CTransaction(vin=(), vout=())
    else:
        try:
            tx = CTransaction.deserialize(ByteReader(bytes.fromhex(first)))
        except Exception as e:
            return _fail(f"bad transaction hex: {e}")

    for cmd in args:
        key_, _, value = cmd.partition("=")
        try:
            tx = _apply(tx, key_, value, params)
        except Exception as e:
            return _fail(f"{cmd}: {e}")

    if as_json:
        print(json.dumps(_decode(tx), indent=2))
    else:
        print(tx.serialize().hex())
    return 0


def _apply(tx: CTransaction, key: str, value: str, params) -> CTransaction:
    vin, vout = list(tx.vin), list(tx.vout)
    version, locktime = tx.version, tx.locktime
    if key == "nversion":
        version = int(value)
    elif key == "locktime":
        locktime = int(value)
    elif key == "in":
        parts = value.split(":")
        txid, n = hex_to_hash(parts[0]), int(parts[1])
        seq = int(parts[2]) if len(parts) > 2 else 0xFFFFFFFF
        vin.append(CTxIn(COutPoint(txid, n), b"", seq))
    elif key == "out":
        amount_s, _, addr = value.partition(":")
        spk = address_to_script(addr, params)
        if spk is None:
            raise ValueError(f"bad address {addr}")
        vout.append(CTxOut(int(round(float(amount_s) * COIN)), spk))
    elif key == "outscript":
        amount_s, _, hexscript = value.partition(":")
        vout.append(CTxOut(int(round(float(amount_s) * COIN)),
                           bytes.fromhex(hexscript)))
    elif key == "outdata":
        vout.append(CTxOut(0, bytes([OP_RETURN]) +
                           push_data_raw(bytes.fromhex(value))))
    elif key == "delin":
        del vin[int(value)]
    elif key == "delout":
        del vout[int(value)]
    elif key == "sign":
        wif, txid_hex, n_s, spk_hex, amount_s = value.split(":")
        signer = CKey.from_wif(wif, params)
        if signer is None:
            raise ValueError("bad WIF key")
        prevout = COutPoint(hex_to_hash(txid_hex), int(n_s))
        spk = bytes.fromhex(spk_hex)
        amount = int(round(float(amount_s) * COIN))
        base = CTransaction(version, tuple(vin), tuple(vout), locktime)
        for i, txin in enumerate(vin):
            if txin.prevout == prevout:
                script_sig = solve_script_sig(
                    spk, base, i, amount,
                    lambda ident: signer if ident in (
                        signer.pubkey_hash, signer.pubkey) else None,
                    SIGHASH_ALL | SIGHASH_FORKID, enable_forkid=True,
                )
                vin[i] = CTxIn(txin.prevout, script_sig, txin.sequence)
                break
        else:
            raise ValueError("no matching input to sign")
    else:
        raise ValueError(f"unknown command {key!r}")
    return CTransaction(version, tuple(vin), tuple(vout), locktime)


def _decode(tx: CTransaction) -> dict:
    return {
        "txid": tx.txid_hex,
        "version": tx.version,
        "locktime": tx.locktime,
        "size": len(tx.serialize()),
        "vin": [
            {"txid": hash_to_hex(i.prevout.hash), "vout": i.prevout.n,
             "scriptSig": i.script_sig.hex(), "sequence": i.sequence}
            for i in tx.vin
        ],
        "vout": [
            {"n": n, "value": o.value / COIN,
             "scriptPubKey": o.script_pubkey.hex()}
            for n, o in enumerate(tx.vout)
        ],
    }


if __name__ == "__main__":
    sys.exit(main())
