"""Raw-transaction RPCs.

Reference: src/rpc/rawtransaction.cpp (sendrawtransaction,
getrawtransaction, decoderawtransaction, createrawtransaction),
src/core_io.h (TxToUniv / ScriptPubKeyToUniv decoding shapes).
"""

from __future__ import annotations

from ..consensus.serialize import hash_to_hex, hex_to_hash
from ..consensus.tx import COutPoint, CTransaction, CTxIn, CTxOut
from ..mempool.mempool import MempoolError
from ..script.script import classify_script, get_script_ops, push_data
from ..wallet.keys import script_to_address
from .registry import (
    RPC_DESERIALIZATION_ERROR,
    RPC_INVALID_ADDRESS_OR_KEY,
    RPC_INVALID_PARAMETER,
    RPC_VERIFY_ALREADY_IN_CHAIN,
    RPC_VERIFY_REJECTED,
    RPCError,
    param_hash,
    require_params,
    rpc_method,
)


def script_asm(script: bytes) -> str:
    """ScriptToAsmStr (src/core_io): best-effort opcode/data rendering."""
    from ..script.script import OPCODE_NAMES

    parts = []
    try:
        for op, data, _ in get_script_ops(script):
            if data is not None:
                parts.append(data.hex() if data else "0")
            else:
                parts.append(OPCODE_NAMES.get(op, f"OP_UNKNOWN_{op:#x}"))
    except Exception:
        parts.append("[error]")
    return " ".join(parts)


def script_pubkey_json(node, script: bytes) -> dict:
    out = {
        "asm": script_asm(script),
        "hex": script.hex(),
        "type": classify_script(script),
    }
    addr = script_to_address(script, node.params)
    if addr is not None:
        out["addresses"] = [addr]
    return out


def tx_to_json(node, tx: CTransaction, block_hash: bytes = None) -> dict:
    out = {
        "txid": tx.txid_hex,
        "hash": tx.txid_hex,
        "version": tx.version,
        "size": tx.size(),
        "locktime": tx.locktime,
        "vin": [],
        "vout": [],
        "hex": tx.serialize().hex(),
    }
    for txin in tx.vin:
        if tx.is_coinbase():
            out["vin"].append({
                "coinbase": txin.script_sig.hex(),
                "sequence": txin.sequence,
            })
        else:
            out["vin"].append({
                "txid": hash_to_hex(txin.prevout.hash),
                "vout": txin.prevout.n,
                "scriptSig": {"asm": script_asm(txin.script_sig),
                              "hex": txin.script_sig.hex()},
                "sequence": txin.sequence,
            })
    for n, txout in enumerate(tx.vout):
        out["vout"].append({
            "value": txout.value / 1e8,
            "n": n,
            "scriptPubKey": script_pubkey_json(node, txout.script_pubkey),
        })
    if block_hash is not None:
        idx = node.chainstate.block_index.get(block_hash)
        if idx is not None and idx in node.chainstate.chain:
            out["blockhash"] = hash_to_hex(block_hash)
            out["confirmations"] = node.chainstate.chain.height() - idx.height + 1
            out["time"] = out["blocktime"] = idx.header.time
    return out


def _parse_tx_hex(hex_str) -> CTransaction:
    try:
        return CTransaction.from_bytes(bytes.fromhex(hex_str))
    except Exception:
        raise RPCError(RPC_DESERIALIZATION_ERROR, "TX decode failed") from None


@rpc_method("sendrawtransaction")
def sendrawtransaction(node, params):
    require_params(params, 1, 2, "sendrawtransaction \"hexstring\" ( allowhighfees )")
    tx = _parse_tx_hex(params[0])
    txid = tx.txid
    if txid not in node.mempool:
        # already confirmed? (reference: RPC_VERIFY_ALREADY_IN_CHAIN)
        if node.chainstate.coins.get_coin(COutPoint(txid, 0)) is not None:
            raise RPCError(RPC_VERIFY_ALREADY_IN_CHAIN,
                           "transaction already in block chain")
        try:
            node.accept_to_mempool(tx)
        except MempoolError as e:
            raise RPCError(RPC_VERIFY_REJECTED,
                           f"{e.reason} {e.detail}".strip()) from None
    if node.connman is not None:
        node.connman.relay_tx(txid)
    return tx.txid_hex


@rpc_method("getrawtransaction")
def getrawtransaction(node, params):
    require_params(params, 1, 2, "getrawtransaction \"txid\" ( verbose )")
    txid = param_hash(params, 0)
    verbose = params[1] if len(params) > 1 else False
    tx = node.mempool.get_tx(txid)
    block_hash = None
    if tx is None:
        block_hash = node.txindex_lookup(txid) if node.txindex else None
        if block_hash is not None:
            block = node.chainstate.get_block(block_hash)
            if block is not None:
                for cand in block.vtx:
                    if cand.txid == txid:
                        tx = cand
                        break
    if tx is None:
        if node.txindex and not node._txindex_synced:
            # the reference's txindex reports "is still syncing" rather
            # than pretending the tx doesn't exist mid-backfill
            raise RPCError(
                RPC_INVALID_ADDRESS_OR_KEY,
                "No such mempool transaction. Blockchain transactions are "
                "still in the process of being indexed.",
            )
        raise RPCError(
            RPC_INVALID_ADDRESS_OR_KEY,
            "No such mempool transaction. Use -txindex to enable "
            "blockchain transaction queries.",
        )
    if not verbose:
        return tx.serialize().hex()
    return tx_to_json(node, tx, block_hash)


@rpc_method("decoderawtransaction")
def decoderawtransaction(node, params):
    require_params(params, 1, 1, "decoderawtransaction \"hexstring\"")
    tx = _parse_tx_hex(params[0])
    out = tx_to_json(node, tx)
    del out["hex"]
    return out


@rpc_method("createrawtransaction")
def createrawtransaction(node, params):
    """createrawtransaction [{"txid","vout"},...] {"address":amount,...}"""
    require_params(params, 2, 3, "createrawtransaction inputs outputs ( locktime )")
    inputs, outputs = params[0], params[1]
    locktime = int(params[2]) if len(params) > 2 else 0
    vin = []
    for inp in inputs:
        sequence = int(inp.get("sequence", 0xFFFFFFFF if locktime == 0 else 0xFFFFFFFE))
        vin.append(CTxIn(COutPoint(hex_to_hash(inp["txid"]), int(inp["vout"])),
                         b"", sequence))
    vout = []
    from ..wallet.keys import address_to_script

    for addr, amount in outputs.items():
        if addr == "data":
            from ..script.script import null_data_script

            vout.append(CTxOut(0, null_data_script(bytes.fromhex(amount))))
            continue
        script = address_to_script(addr, node.params)
        if script is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, f"Invalid address: {addr}")
        vout.append(CTxOut(int(round(float(amount) * 1e8)), script))
    tx = CTransaction(version=1, vin=tuple(vin), vout=tuple(vout), locktime=locktime)
    return tx.serialize().hex()


@rpc_method("decodescript")
def decodescript(node, params):
    require_params(params, 1, 1, "decodescript \"hexstring\"")
    try:
        script = bytes.fromhex(params[0])
    except ValueError:
        raise RPCError(RPC_INVALID_PARAMETER, "argument must be hexadecimal string") from None
    out = script_pubkey_json(node, script)
    del out["hex"]  # reference omits hex in decodescript
    from ..crypto.hashes import hash160
    from ..script.script import p2sh_script

    out["p2sh"] = script_to_address(p2sh_script(hash160(script)), node.params)
    return out


@rpc_method("signrawtransaction")
def signrawtransaction(node, params):
    """signrawtransaction (src/rpc/rawtransaction.cpp:~700): sign inputs
    using wallet keys or caller-provided WIF keys; prevout scripts come from
    the UTXO set, the mempool, or the caller's prevtxs array. Partial
    signing returns complete=false with per-input errors."""
    require_params(params, 1, 3,
                   "signrawtransaction \"hexstring\" ( [{prevtxs},...] "
                   "[\"privatekey\",...] )")
    from ..consensus.tx import COIN
    from ..script.sighash import SIGHASH_ALL, SIGHASH_FORKID, SighashCache
    from ..wallet.keys import CKey
    from ..wallet.signing import SignError, solve_script_sig

    tx = _parse_tx_hex(params[0])
    prevtxs = params[1] if len(params) > 1 and params[1] else []
    privkeys = params[2] if len(params) > 2 and params[2] else None

    spents = {}
    for p in prevtxs:
        spk = bytes.fromhex(p["scriptPubKey"])
        amount = int(round(float(p.get("amount", 0)) * COIN))
        spents[(hex_to_hash(p["txid"]), int(p["vout"]))] = (spk, amount)
    for txin in tx.vin:
        key = (txin.prevout.hash, txin.prevout.n)
        if key in spents:
            continue
        coin = node.chainstate.coins.get_coin(txin.prevout)
        if coin is not None:
            spents[key] = (coin.out.script_pubkey, coin.out.value)
            continue
        parent = node.mempool.get_tx(txin.prevout.hash)
        if parent is not None and txin.prevout.n < len(parent.vout):
            out = parent.vout[txin.prevout.n]
            spents[key] = (out.script_pubkey, out.value)

    if privkeys is not None:
        keymap = {}
        for wif in privkeys:
            k = CKey.from_wif(wif, node.params)
            if k is None:
                raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                               "Invalid private key")
            keymap[k.pubkey_hash] = k
            keymap[k.pubkey] = k
        key_for_id = keymap.get
    else:
        wallet = node.load_wallet()
        wallet.maybe_relock()
        key_for_id = wallet.key_for_id

    hashtype = SIGHASH_ALL | SIGHASH_FORKID
    cache = SighashCache(tx)
    new_vin = []
    errors = []
    for i, txin in enumerate(tx.vin):
        ent = spents.get((txin.prevout.hash, txin.prevout.n))
        if ent is None:
            errors.append({
                "txid": hash_to_hex(txin.prevout.hash),
                "vout": txin.prevout.n,
                "error": "Input not found or already spent",
            })
            new_vin.append(txin)
            continue
        spk, amount = ent
        try:
            script_sig = solve_script_sig(
                spk, tx, i, amount, key_for_id, hashtype,
                enable_forkid=True, cache=cache,
            )
            new_vin.append(CTxIn(txin.prevout, script_sig, txin.sequence))
        except SignError as e:
            errors.append({
                "txid": hash_to_hex(txin.prevout.hash),
                "vout": txin.prevout.n,
                "error": str(e),
            })
            new_vin.append(txin)
    signed = CTransaction(tx.version, tuple(new_vin), tx.vout, tx.locktime)
    out = {"hex": signed.serialize().hex(), "complete": not errors}
    if errors:
        out["errors"] = errors
    return out


@rpc_method("gettxoutproof")
def gettxoutproof(node, params):
    """gettxoutproof ["txid",...] ( "blockhash" ) — hex-serialized
    CMerkleBlock proving the txids' inclusion (rpc/rawtransaction.cpp)."""
    require_params(params, 1, 2, "gettxoutproof [\"txid\",...] ( \"blockhash\" )")
    from ..consensus.merkleblock import CMerkleBlock

    if not isinstance(params[0], list) or not params[0]:
        raise RPCError(RPC_INVALID_PARAMETER, "Parameter 1 must be a non-empty array")
    txids = set()
    for t in params[0]:
        try:
            h = hex_to_hash(t)
        except Exception:
            raise RPCError(RPC_INVALID_PARAMETER,
                           f"Invalid txid: {t!r}") from None
        if h in txids:
            raise RPCError(RPC_INVALID_PARAMETER, f"Duplicated txid: {t}")
        txids.add(h)

    block_hash = None
    if len(params) > 1:
        block_hash = param_hash(params, 1)
        if node.chainstate.block_index.get(block_hash) is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Block not found")
    else:
        # locate via txindex (or the UTXO set for an unspent output)
        any_txid = next(iter(txids))
        if node.txindex:
            block_hash = node.txindex_lookup(any_txid)
        if block_hash is None:
            from ..consensus.tx import COutPoint

            for n in range(64):
                coin = node.chainstate.coins.get_coin(COutPoint(any_txid, n))
                if coin is not None and coin.height >= 0:
                    idx = node.chainstate.chain[coin.height]
                    if idx is not None:
                        block_hash = idx.hash
                    break
        if block_hash is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                           "Transaction not yet in block")
    block = node.chainstate.get_block(block_hash)
    if block is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Block not available")
    in_block = {tx.txid for tx in block.vtx}
    if not txids <= in_block:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Not all transactions found in specified or retrieved block")
    return CMerkleBlock.from_block(block, txid_set=txids).serialize().hex()


@rpc_method("verifytxoutproof")
def verifytxoutproof(node, params):
    """verifytxoutproof "proof" — txids the proof commits to, [] if the
    proven block is not in the active chain, error if malformed."""
    require_params(params, 1, 1, "verifytxoutproof \"proof\"")
    from ..consensus.merkleblock import CMerkleBlock

    try:
        mb = CMerkleBlock.from_bytes(bytes.fromhex(params[0]))
    except Exception:
        raise RPCError(RPC_DESERIALIZATION_ERROR, "Bad proof") from None
    got = mb.pmt.extract_matches()
    if got is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid proof")
    root, matches = got
    if root != mb.header.hash_merkle_root:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Merkle root in proof does not match block header")
    idx = node.chainstate.block_index.get(mb.header.get_hash())
    if idx is None or node.chainstate.chain[idx.height] is not idx:
        return []  # proof is internally valid but block isn't in our chain
    return [hash_to_hex(txid) for _pos, txid in matches]


@rpc_method("fundrawtransaction")
def fundrawtransaction(node, params):
    """fundrawtransaction "hexstring" — add wallet inputs (and change)
    until the outputs + fee are covered; inputs stay UNSIGNED
    (src/wallet/rpcwallet.cpp fundrawtransaction)."""
    require_params(params, 1, 2, "fundrawtransaction \"hexstring\"")
    from ..consensus.tx import COIN
    from .wallet import RPC_WALLET_ERROR, _wallet, _wallet_fee

    tx = _parse_tx_hex(params[0])
    w = _wallet(node)
    tip = node.chainstate.tip().height
    fee = _wallet_fee(node)
    out_value = tx.total_output_value()
    # value already provided by existing inputs (wallet coins only)
    in_value = 0
    for txin in tx.vin:
        coin = w.coins.get(txin.prevout)
        if coin is not None:
            in_value += coin.txout.value
    need = out_value + fee - in_value
    selected = []
    if need > 0:
        coins = sorted(
            (c for c in w.available_coins(tip)
             if w.can_sign(c.txout.script_pubkey)
             and not any(i.prevout == c.outpoint for i in tx.vin)),
            key=lambda c: c.txout.value, reverse=True,
        )
        got = 0
        for c in coins:
            selected.append(c)
            got += c.txout.value
            if got >= need:
                break
        if got < need:
            raise RPCError(RPC_WALLET_ERROR, "Insufficient funds")
        in_value += got
    change = in_value - out_value - fee
    vout = list(tx.vout)
    changepos = -1
    if change > 546:
        from ..wallet.wallet import WalletError

        try:
            change_key = w.derive_new_key()
        except WalletError as e:
            from .wallet import RPC_WALLET_UNLOCK_NEEDED

            raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None
        w.add_key(change_key)
        changepos = len(vout)
        vout.append(CTxOut(change, change_key.p2pkh_script()))
    else:
        fee += max(change, 0)  # dust change folds into the fee — report it
    funded = CTransaction(
        tx.version,
        tuple(tx.vin) + tuple(CTxIn(c.outpoint) for c in selected),
        tuple(vout),
        tx.locktime,
    )
    return {
        "hex": funded.serialize().hex(),
        "fee": fee / COIN,
        "changepos": changepos,
    }
