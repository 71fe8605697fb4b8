"""Wallet RPCs — src/wallet/rpcwallet.cpp / rpcdump.cpp.

The wallet is loaded lazily on first wallet-RPC use (the reference loads at
init; lazy keeps non-wallet nodes wallet-free). All handlers already hold
cs_main via the server dispatch; wallet state is only touched under it.
"""

from __future__ import annotations

from ..consensus.serialize import hash_to_hex
from ..consensus.tx import COIN
from ..mempool.mempool import MempoolError
from ..wallet.keys import CKey
from ..wallet.wallet import WalletError
from .registry import (
    RPC_INVALID_ADDRESS_OR_KEY,
    RPC_INVALID_PARAMETER,
    RPC_MISC_ERROR,
    RPC_TYPE_ERROR,
    RPCError,
    require_params,
    rpc_method,
)

RPC_WALLET_ERROR = -4
RPC_WALLET_PASSPHRASE_INCORRECT = -14
RPC_WALLET_WRONG_ENC_STATE = -15
RPC_WALLET_UNLOCK_NEEDED = -13


def _wallet(node):
    w = node.load_wallet()
    w.maybe_relock()
    return w


@rpc_method("getnewaddress")
def getnewaddress(node, params):
    require_params(params, 0, 1, "getnewaddress ( \"account\" )")
    try:
        return _wallet(node).get_new_address(
            str(params[0]) if params and params[0] else "")
    except WalletError as e:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None


@rpc_method("getbalance")
def getbalance(node, params):
    w = _wallet(node)
    return w.balance(node.chainstate.tip().height) / COIN


@rpc_method("listunspent")
def listunspent(node, params):
    w = _wallet(node)
    tip = node.chainstate.tip().height
    out = []
    for coin in w.available_coins(tip, include_watch_only=True):
        out.append({
            "txid": hash_to_hex(coin.outpoint.hash),
            "vout": coin.outpoint.n,
            "amount": coin.txout.value / COIN,
            "confirmations": tip - coin.height + 1,
            "scriptPubKey": coin.txout.script_pubkey.hex(),
            "spendable": (not w.is_locked
                          and w.can_sign(coin.txout.script_pubkey)),
        })
    return out


@rpc_method("sendtoaddress")
def sendtoaddress(node, params):
    require_params(params, 2, 2, "sendtoaddress \"address\" amount")
    address = params[0]
    amount = int(round(float(params[1]) * COIN))
    if amount <= 0:
        raise RPCError(RPC_INVALID_PARAMETER, "Invalid amount for send")
    w = _wallet(node)
    try:
        tx = w.create_transaction(
            address, amount, node.chainstate.tip().height,
            fee=_wallet_fee(node), enable_forkid=True,
            fee_rate=_wallet_fee(node),
        )
    except WalletError as e:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None
    except ValueError as e:
        raise RPCError(RPC_WALLET_ERROR, str(e)) from None
    try:
        node.accept_to_mempool(tx)
    except MempoolError as e:
        raise RPCError(RPC_WALLET_ERROR, f"transaction rejected: {e}") from None
    if node.connman is not None:
        node.connman.relay_tx(tx.txid)
    return tx.txid_hex


@rpc_method("getwalletinfo")
def getwalletinfo(node, params):
    w = _wallet(node)
    tip = node.chainstate.tip().height
    info = {
        "walletname": "wallet.json",
        "balance": w.balance(tip) / COIN,
        "txcount": len(w.coins),
        "keypoolsize": len(w.keys_by_pubkey) or len(w.encrypted_keys),
    }
    if w.is_crypted:
        info["unlocked_until"] = (
            0 if w.is_locked else int(w.unlocked_until)
        )
    if w.hd_seed is not None:
        from ..crypto.hashes import hash160
        from ..wallet.bip32 import ExtKey

        info["hdmasterkeyid"] = hash160(
            ExtKey.from_seed(w.hd_seed).pubkey_bytes()
        ).hex()
    return info


@rpc_method("encryptwallet")
def encryptwallet(node, params):
    require_params(params, 1, 1, "encryptwallet \"passphrase\"")
    w = _wallet(node)
    if w.is_crypted:
        raise RPCError(RPC_WALLET_WRONG_ENC_STATE,
                       "Wallet is already encrypted")
    try:
        w.encrypt(str(params[0]))
    except WalletError as e:
        raise RPCError(RPC_MISC_ERROR, str(e)) from None
    # the reference shuts down after encryptwallet; we just lock
    return ("wallet encrypted; the wallet is now locked — use "
            "walletpassphrase to unlock")


@rpc_method("walletpassphrase")
def walletpassphrase(node, params):
    require_params(params, 2, 2, "walletpassphrase \"passphrase\" timeout")
    w = _wallet(node)
    if not w.is_crypted:
        raise RPCError(RPC_WALLET_WRONG_ENC_STATE,
                       "running with an unencrypted wallet, but "
                       "walletpassphrase was called")
    timeout = float(params[1])
    if timeout <= 0:
        raise RPCError(RPC_INVALID_PARAMETER, "timeout must be positive")
    if not w.unlock(str(params[0]), timeout):
        raise RPCError(RPC_WALLET_PASSPHRASE_INCORRECT,
                       "Error: The wallet passphrase entered was incorrect.")
    return None


@rpc_method("walletlock")
def walletlock(node, params):
    w = _wallet(node)
    if not w.is_crypted:
        raise RPCError(RPC_WALLET_WRONG_ENC_STATE,
                       "running with an unencrypted wallet, but "
                       "walletlock was called")
    w.lock()
    return None


@rpc_method("walletpassphrasechange")
def walletpassphrasechange(node, params):
    require_params(params, 2, 2,
                   "walletpassphrasechange \"oldpassphrase\" \"newpassphrase\"")
    w = _wallet(node)
    if not w.is_crypted:
        raise RPCError(RPC_WALLET_WRONG_ENC_STATE,
                       "running with an unencrypted wallet")
    if not w.change_passphrase(str(params[0]), str(params[1])):
        raise RPCError(RPC_WALLET_PASSPHRASE_INCORRECT,
                       "Error: The wallet passphrase entered was incorrect.")
    return None


@rpc_method("dumpprivkey")
def dumpprivkey(node, params):
    require_params(params, 1, 1, "dumpprivkey \"address\"")
    from ..wallet.keys import address_to_script
    from ..script.script import get_script_ops

    w = _wallet(node)
    if w.is_locked:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED,
                       "Error: Please enter the wallet passphrase with "
                       "walletpassphrase first.")
    spk = address_to_script(params[0], node.params)
    if spk is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid address")
    pkh = list(get_script_ops(spk))[2][1]
    key = w.keys_by_pkh.get(pkh)
    if key is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Private key for address is not known")
    return key.to_wif(node.params)


@rpc_method("importprivkey")
def importprivkey(node, params):
    require_params(params, 1, 2, "importprivkey \"privkey\" ( \"label\" )")
    w = _wallet(node)
    key = CKey.from_wif(params[0], node.params)
    if key is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Invalid private key encoding")
    try:
        w.add_key(key)
    except WalletError as e:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None
    node._rescan_wallet()
    return None

@rpc_method("signmessage")
def signmessage(node, params):
    require_params(params, 2, 2, "signmessage \"address\" \"message\"")
    from ..wallet.keys import address_to_script
    from ..wallet.message import sign_message
    from ..script.script import get_script_ops

    w = _wallet(node)
    if w.is_locked:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED,
                       "Error: Please enter the wallet passphrase with "
                       "walletpassphrase first.")
    spk = address_to_script(params[0], node.params)
    if spk is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid address")
    try:
        pkh = list(get_script_ops(spk))[2][1]
    except Exception:
        pkh = None
    if pkh is None or len(pkh) != 20:  # P2SH scripts land here too
        raise RPCError(RPC_TYPE_ERROR, "Address does not refer to key")
    key = w.keys_by_pkh.get(pkh)
    if key is None:
        raise RPCError(RPC_WALLET_ERROR, "Private key not available")
    return sign_message(key, str(params[1]))


def _tx_log_json(node, w, txid: bytes, entry: dict) -> dict:
    """One listtransactions/gettransaction row (rpcwallet.cpp WalletTxToJSON)."""
    tip = node.chainstate.tip().height
    height = entry["height"]
    confirmations = 0 if height < 0 else tip - height + 1
    net = entry["received"] - entry["sent"]
    if entry["is_coinbase"]:
        maturity = node.params.consensus.coinbase_maturity
        category = "generate" if confirmations >= maturity else "immature"
    elif entry["sent"] > 0:
        category = "send"
    else:
        category = "receive"
    out = {
        "txid": hash_to_hex(txid),
        "category": category,
        "amount": net / COIN,
        "confirmations": confirmations,
    }
    if height >= 0:
        idx = node.chainstate.chain[height]
        if idx is not None:
            out["blockhash"] = hash_to_hex(idx.hash)
            out["blocktime"] = idx.header.time
    return out


@rpc_method("listtransactions")
def listtransactions(node, params):
    """listtransactions ( "account" count skip ) — newest first."""
    count = int(params[1]) if len(params) > 1 else 10
    skip = int(params[2]) if len(params) > 2 else 0
    w = _wallet(node)
    entries = list(w.tx_log.items())[::-1][skip:skip + count]
    return [_tx_log_json(node, w, txid, e) for txid, e in entries][::-1]


@rpc_method("gettransaction")
def gettransaction(node, params):
    require_params(params, 1, 1, "gettransaction \"txid\"")
    from ..consensus.serialize import hex_to_hash

    w = _wallet(node)
    txid = hex_to_hash(params[0])
    entry = w.tx_log.get(txid)
    if entry is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Invalid or non-wallet transaction id")
    out = _tx_log_json(node, w, txid, entry)
    out["fee"] = 0.0  # fee tracking requires full input provenance
    out["details"] = [out.copy()]
    return out


def _received_by_spk(w, minconf: int, tip: int) -> dict:
    """spk -> total satoshis received across wallet coins (spent or not),
    rpcwallet.cpp GetReceived semantics: receipts count even if later
    spent, gated on confirmations."""
    out = {}
    for coin in w.coins.values():
        conf = 0 if coin.height < 0 else tip - coin.height + 1
        if conf < minconf:
            continue
        spk = coin.txout.script_pubkey
        out[spk] = out.get(spk, 0) + coin.txout.value
    return out


@rpc_method("getreceivedbyaddress")
def getreceivedbyaddress(node, params):
    require_params(params, 1, 2, "getreceivedbyaddress \"address\" ( minconf )")
    from ..wallet.keys import address_to_script

    spk = address_to_script(params[0], node.params)
    if spk is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid address")
    minconf = int(params[1]) if len(params) > 1 else 1
    w = _wallet(node)
    tip = node.chainstate.tip().height
    return _received_by_spk(w, minconf, tip).get(spk, 0) / COIN


@rpc_method("listreceivedbyaddress")
def listreceivedbyaddress(node, params):
    minconf = int(params[0]) if params else 1
    include_empty = bool(params[1]) if len(params) > 1 else False
    from ..wallet.keys import script_to_address

    w = _wallet(node)
    tip = node.chainstate.tip().height
    received = _received_by_spk(w, minconf, tip)
    out = []
    seen_spks = set(received)
    if include_empty:
        from ..script.script import p2pkh_script

        for pkh in w._pkh_index:
            seen_spks.add(p2pkh_script(pkh))
    for spk in seen_spks:
        addr = script_to_address(spk, node.params)
        if addr is None:
            continue
        out.append({
            "address": addr,
            "amount": received.get(spk, 0) / COIN,
            "confirmations": minconf,
        })
    return sorted(out, key=lambda r: r["address"])


@rpc_method("backupwallet")
def backupwallet(node, params):
    require_params(params, 1, 1, "backupwallet \"destination\"")
    import shutil

    w = _wallet(node)
    w.save()
    if not w.path:
        raise RPCError(RPC_WALLET_ERROR, "wallet has no backing file")
    try:
        shutil.copyfile(w.path, str(params[0]))
    except OSError as e:
        raise RPCError(RPC_WALLET_ERROR, f"Error: {e}") from None
    return None


@rpc_method("dumpwallet")
def dumpwallet(node, params):
    """dumpwallet "filename" — human-readable key dump (rpcdump.cpp):
    one WIF per line with its hdkeypath; the HD seed leads the file."""
    require_params(params, 1, 1, "dumpwallet \"filename\"")
    import time as _t

    w = _wallet(node)
    if w.is_locked:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED,
                       "Error: Please enter the wallet passphrase with "
                       "walletpassphrase first.")
    lines = [
        "# Wallet dump created by bcpd",
        f"# * Created on {int(_t.time())}",
    ]
    if w.hd_seed is not None:
        from ..wallet.bip32 import ExtKey

        lines.append("# extended private masterkey: "
                     + ExtKey.from_seed(w.hd_seed).serialize())
    for key in w.keys_by_pubkey.values():
        path = w.key_paths.get(key.pubkey, "")
        tag = f"hdkeypath={path}" if path else "imported"
        lines.append(f"{key.to_wif(node.params)} 0 {tag} "
                     f"# addr={key.p2pkh_address(node.params)}")
    lines.append("# End of dump")
    import os as _os

    try:
        # 0600 like the wallet file itself — this is every private key
        fd = _os.open(str(params[0]),
                      _os.O_WRONLY | _os.O_CREAT | _os.O_TRUNC, 0o600)
        with _os.fdopen(fd, "w") as f:
            f.write("\n".join(lines) + "\n")
    except OSError as e:
        raise RPCError(RPC_WALLET_ERROR, f"Error: {e}") from None
    return None


@rpc_method("importwallet")
def importwallet(node, params):
    """importwallet "filename" — re-add every WIF line from a dump."""
    require_params(params, 1, 1, "importwallet \"filename\"")
    w = _wallet(node)
    if w.is_locked:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED,
                       "Error: Please enter the wallet passphrase with "
                       "walletpassphrase first.")
    try:
        with open(str(params[0])) as f:
            content = f.read()
    except OSError as e:
        raise RPCError(RPC_WALLET_ERROR, f"Error: {e}") from None
    n = 0
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key = CKey.from_wif(line.split()[0], node.params)
        if key is not None and key.pubkey not in w.keys_by_pubkey:
            w.add_key(key, persist=False)
            n += 1
    w.save()
    if n:
        node._rescan_wallet()
    return None


@rpc_method("keypoolrefill")
def keypoolrefill(node, params):
    """keypoolrefill ( newsize ) — keys derive on demand from the HD chain,
    so the pool never empties while unlocked; kept for parity."""
    w = _wallet(node)
    if w.is_locked:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED,
                       "Error: Please enter the wallet passphrase with "
                       "walletpassphrase first.")
    return None


def _wallet_fee(node) -> int:
    """Flat per-tx fee: -paytxfee/settxfee rate if set (treated per-kB
    against the typical ~1 kB wallet tx), else the relay floor."""
    return max(1000, getattr(node, "paytxfee", 0))


@rpc_method("settxfee")
def settxfee(node, params):
    require_params(params, 1, 1, "settxfee amount")
    rate = float(params[0])
    if rate < 0:
        raise RPCError(RPC_INVALID_PARAMETER, "amount cannot be negative")
    node.paytxfee = int(round(rate * COIN))
    return True


@rpc_method("sendmany")
def sendmany(node, params):
    """sendmany "" {"address":amount,...} — one tx, many outputs."""
    require_params(params, 2, 4,
                   "sendmany \"account\" {\"address\":amount,...}")
    from ..wallet.keys import address_to_script

    if not isinstance(params[1], dict) or not params[1]:
        raise RPCError(RPC_INVALID_PARAMETER,
                       "Parameter 2 must be a non-empty object")
    outputs = []
    for addr, amt in params[1].items():
        spk = address_to_script(addr, node.params)
        if spk is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                           f"Invalid address: {addr}")
        value = int(round(float(amt) * COIN))
        if value <= 0:
            raise RPCError(RPC_INVALID_PARAMETER, "Invalid amount for send")
        outputs.append((spk, value))
    w = _wallet(node)
    try:
        tx = w.create_transaction_multi(
            outputs, node.chainstate.tip().height,
            fee=_wallet_fee(node), enable_forkid=True,
            fee_rate=_wallet_fee(node),
        )
    except WalletError as e:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None
    except ValueError as e:
        raise RPCError(RPC_WALLET_ERROR, str(e)) from None
    try:
        node.accept_to_mempool(tx)
    except MempoolError as e:
        raise RPCError(RPC_WALLET_ERROR, f"transaction rejected: {e}") from None
    if node.connman is not None:
        node.connman.relay_tx(tx.txid)
    return tx.txid_hex


@rpc_method("lockunspent")
def lockunspent(node, params):
    """lockunspent unlock ([{"txid":..,"vout":..},...]) — true unlocks."""
    require_params(params, 1, 2, "lockunspent unlock ( [{\"txid\":...}] )")
    from ..consensus.serialize import hex_to_hash
    from ..consensus.tx import COutPoint

    unlock = bool(params[0])
    w = _wallet(node)
    if len(params) < 2 or not params[1]:
        if unlock:
            w.locked_coins.clear()  # unlock-all form
            return True
        raise RPCError(RPC_INVALID_PARAMETER,
                       "Invalid parameter, expected locked outputs")
    for item in params[1]:
        try:
            op = COutPoint(hex_to_hash(item["txid"]), int(item["vout"]))
        except Exception:
            raise RPCError(RPC_INVALID_PARAMETER,
                           "Invalid parameter, invalid outpoint") from None
        if unlock:
            w.locked_coins.discard(op)
        else:
            w.locked_coins.add(op)
    return True


@rpc_method("listlockunspent")
def listlockunspent(node, params):
    w = _wallet(node)
    return [
        {"txid": hash_to_hex(op.hash), "vout": op.n}
        for op in sorted(w.locked_coins, key=lambda o: (o.hash, o.n))
    ]


@rpc_method("listsinceblock")
def listsinceblock(node, params):
    """listsinceblock ( "blockhash" ) — wallet txs at heights above the
    given block (or all), plus the lastblock cursor."""
    from ..consensus.serialize import hex_to_hash

    w = _wallet(node)
    since_height = -1
    if params and params[0]:
        idx = node.chainstate.block_index.get(hex_to_hash(params[0]))
        if idx is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Block not found")
        since_height = idx.height
    txs = []
    for txid, entry in w.tx_log.items():
        if entry.get("abandoned"):
            continue
        if entry["height"] < 0 or entry["height"] > since_height:
            txs.append(_tx_log_json(node, w, txid, entry))
    return {
        "transactions": txs,
        "lastblock": hash_to_hex(node.chainstate.tip().hash),
    }


@rpc_method("abandontransaction")
def abandontransaction(node, params):
    require_params(params, 1, 1, "abandontransaction \"txid\"")
    from ..consensus.serialize import hex_to_hash

    txid = hex_to_hash(params[0])
    if txid in node.mempool:
        raise RPCError(RPC_MISC_ERROR,
                       "Transaction not eligible for abandonment")
    w = _wallet(node)
    if txid not in w.tx_log:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Invalid or non-wallet transaction id")
    try:
        w.abandon_transaction(txid)
    except WalletError:
        raise RPCError(RPC_MISC_ERROR,
                       "Transaction not eligible for abandonment") from None
    return None


@rpc_method("addmultisigaddress")
def addmultisigaddress(node, params):
    """addmultisigaddress nrequired ["key",...] — watch the P2SH script."""
    require_params(params, 2, 3,
                   "addmultisigaddress nrequired [\"key\",...]")
    from ..crypto.hashes import hash160
    from ..script.script import p2sh_script
    from ..wallet.keys import script_to_address

    w = _wallet(node)
    m, redeem = _parse_multisig_params(node, w, params)
    spk = p2sh_script(hash160(redeem))
    w.watched_scripts.add(spk)
    w.save()
    return script_to_address(spk, node.params)


def _parse_multisig_params(node, wallet, params):
    """Shared createmultisig/addmultisigaddress validation → (m, redeem)."""
    from ..script.script import multisig_script

    m = int(params[0])
    keys_param = params[1]
    if not isinstance(keys_param, list) or not keys_param:
        raise RPCError(RPC_INVALID_PARAMETER, "keys must be a non-empty array")
    if m < 1:
        raise RPCError(RPC_INVALID_PARAMETER,
                       "a multisignature address must require at least one key")
    if m > len(keys_param):
        raise RPCError(RPC_INVALID_PARAMETER,
                       "not enough keys supplied (got %d, need %d)"
                       % (len(keys_param), m))
    from ..script.script import MAX_PUBKEYS_PER_MULTISIG

    if len(keys_param) > MAX_PUBKEYS_PER_MULTISIG:
        raise RPCError(RPC_INVALID_PARAMETER,
                       "Number of addresses involved in the multisignature "
                       f"address creation > {MAX_PUBKEYS_PER_MULTISIG}")
    pubkeys = []
    for item in keys_param:
        item = str(item)
        pk = None
        if len(item) in (66, 130):
            try:
                pk = bytes.fromhex(item)
            except ValueError:
                pk = None
        if pk is None and wallet is not None:
            # address form: look up the wallet key
            from ..wallet.keys import address_to_script
            from ..script.script import get_script_ops

            spk = address_to_script(item, node.params)
            if spk is not None:
                try:
                    pkh = list(get_script_ops(spk))[2][1]
                    key = wallet.keys_by_pkh.get(pkh)
                    if key is not None:
                        pk = key.pubkey
                    elif pkh in wallet._pkh_index:
                        pk = wallet._pkh_index[pkh]
                except Exception:
                    pk = None
        if pk is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                           f"Invalid public key or address: {item}")
        from ..crypto.secp256k1 import pubkey_parse

        if pubkey_parse(pk) is None:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                           f"Invalid public key: {item}")
        pubkeys.append(pk)
    return m, multisig_script(m, pubkeys)


# ---- legacy accounts API (rpcwallet.cpp, deprecated in later lineages
# but part of this one's surface). Account balance here = unspent coins
# held by the account's labelled addresses + `move` deltas — the
# reference's full debit/credit history bookkeeping collapsed to its
# steady-state observable. ----


def _address_of_coin(node, coin):
    from ..wallet.keys import script_to_address

    return script_to_address(coin.txout.script_pubkey, node.params)


def _account_balances(node, w, include_watch_only: bool = False,
                      minconf: int = 1) -> dict:
    tip = node.chainstate.tip().height
    out = {"": 0}
    for acct in set(w.labels.values()) | set(w.account_moves):
        out.setdefault(acct, 0)
    for coin in w.available_coins(tip, include_watch_only=include_watch_only):
        conf = 0 if coin.height < 0 else tip - coin.height + 1
        if conf < minconf:
            continue
        addr = _address_of_coin(node, coin)
        acct = w.labels.get(addr, "") if addr else ""
        out[acct] = out.get(acct, 0) + coin.txout.value
    for acct, delta in w.account_moves.items():
        out[acct] = out.get(acct, 0) + delta
        out[""] = out.get("", 0) - delta
    return out


@rpc_method("getaccount")
def getaccount(node, params):
    require_params(params, 1, 1, "getaccount \"address\"")
    return _wallet(node).labels.get(str(params[0]), "")


@rpc_method("setaccount")
def setaccount(node, params):
    require_params(params, 2, 2, "setaccount \"address\" \"account\"")
    from ..wallet.keys import address_to_script

    if address_to_script(str(params[0]), node.params) is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid address")
    w = _wallet(node)
    w.labels[str(params[0])] = str(params[1])
    w.save()
    return None


@rpc_method("getaccountaddress")
def getaccountaddress(node, params):
    """getaccountaddress "account" — a stable receiving address per
    account (fresh one on first use)."""
    require_params(params, 1, 1, "getaccountaddress \"account\"")
    account = str(params[0])
    w = _wallet(node)
    addr = w.account_addresses.get(account)
    if addr is not None:
        return addr
    try:
        addr = w.get_new_address(account)
    except WalletError as e:
        raise RPCError(RPC_WALLET_UNLOCK_NEEDED, str(e)) from None
    w.account_addresses[account] = addr
    w.save()
    return addr


@rpc_method("getaddressesbyaccount")
def getaddressesbyaccount(node, params):
    require_params(params, 1, 1, "getaddressesbyaccount \"account\"")
    w = _wallet(node)
    account = str(params[0])
    return sorted(a for a, acct in w.labels.items() if acct == account)


@rpc_method("listaccounts")
def listaccounts(node, params):
    """listaccounts ( minconf includeWatchonly ) — watch-only coins count
    only with the explicit flag, like the reference."""
    minconf = int(params[0]) if params and params[0] is not None else 1
    include_watch = bool(params[1]) if len(params) > 1 else False
    w = _wallet(node)
    return {acct: bal / COIN
            for acct, bal in _account_balances(
                node, w, include_watch, minconf).items()}


@rpc_method("getreceivedbyaccount")
def getreceivedbyaccount(node, params):
    require_params(params, 1, 2, "getreceivedbyaccount \"account\" ( minconf )")
    from ..wallet.keys import address_to_script

    account = str(params[0])
    minconf = int(params[1]) if len(params) > 1 else 1
    w = _wallet(node)
    tip = node.chainstate.tip().height
    received = _received_by_spk(w, minconf, tip)
    total = 0
    for addr, acct in w.labels.items():
        if acct == account:
            spk = address_to_script(addr, node.params)
            if spk is not None:
                total += received.get(spk, 0)
    return total / COIN


@rpc_method("move")
def move(node, params):
    """move "fromaccount" "toaccount" amount — internal bookkeeping only."""
    require_params(params, 3, 5, "move \"fromaccount\" \"toaccount\" amount")
    w = _wallet(node)
    amount = int(round(float(params[2]) * COIN))
    src, dst = str(params[0]), str(params[1])
    w.account_moves[src] = w.account_moves.get(src, 0) - amount
    w.account_moves[dst] = w.account_moves.get(dst, 0) + amount
    # "" is the implicit default account; drop zero entries
    for acct in (src, dst):
        if w.account_moves.get(acct) == 0:
            w.account_moves.pop(acct, None)
    w.save()
    return True


@rpc_method("sendfrom")
def sendfrom(node, params):
    """sendfrom "account" "address" amount — spends from the shared pool
    like the reference (accounts never restricted coin selection), gated
    on the account's balance. Under this wallet's steady-state account
    model (balances derive from labelled-coin ownership + move deltas) a
    spend of the account's own coins debits it naturally, so no extra
    delta is recorded — recording one on top double-counts."""
    require_params(params, 3, 6, "sendfrom \"account\" \"toaddress\" amount")
    RPC_WALLET_INSUFFICIENT_FUNDS = -6
    account = str(params[0])
    amount = int(round(float(params[2]) * COIN))
    fee = _wallet_fee(node)
    w = _wallet(node)
    if _account_balances(node, w).get(account, 0) < amount + fee:
        raise RPCError(RPC_WALLET_INSUFFICIENT_FUNDS,
                       "Account has insufficient funds")
    return sendtoaddress(node, [params[1], params[2]])


# ---- watch-only imports (rpcdump.cpp importaddress/importpubkey) ----


@rpc_method("importaddress")
def importaddress(node, params):
    """importaddress "address-or-script" ( "label" rescan )"""
    require_params(params, 1, 3, "importaddress \"address\" ( \"label\" rescan )")
    from ..wallet.keys import address_to_script

    w = _wallet(node)
    target = str(params[0])
    spk = address_to_script(target, node.params)
    if spk is None:
        try:
            spk = bytes.fromhex(target)  # raw script form
        except ValueError:
            raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                           "Invalid address or script") from None
    w.watched_scripts.add(spk)
    if len(params) > 1 and params[1]:
        w.labels[target] = str(params[1])
    w.save()
    rescan = bool(params[2]) if len(params) > 2 else True
    if rescan:
        node._rescan_wallet()
    return None


@rpc_method("importpubkey")
def importpubkey(node, params):
    """importpubkey "pubkey" ( "label" rescan ) — watch P2PK + P2PKH."""
    require_params(params, 1, 3, "importpubkey \"pubkey\" ( \"label\" rescan )")
    from ..crypto.secp256k1 import pubkey_parse
    from ..script.script import p2pk_script, p2pkh_script_for_pubkey

    try:
        pk = bytes.fromhex(str(params[0]))
    except ValueError:
        pk = b""
    if not pk or pubkey_parse(pk) is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Pubkey must be a valid hex public key")
    w = _wallet(node)
    w.watched_scripts.add(p2pk_script(pk))
    w.watched_scripts.add(p2pkh_script_for_pubkey(pk))
    if len(params) > 1 and params[1]:
        from ..crypto.hashes import hash160
        from ..crypto.base58 import b58check_encode

        addr = b58check_encode(
            bytes([node.params.pubkey_addr_prefix]) + hash160(pk))
        w.labels[addr] = str(params[1])
    w.save()
    rescan = bool(params[2]) if len(params) > 2 else True
    if rescan:
        node._rescan_wallet()
    return None


@rpc_method("importmulti")
def importmulti(node, params):
    """importmulti [{"scriptPubKey":{"address":...}|"<hex>", "timestamp":...,
    "keys":[wif], "pubkeys":[hex], "redeemscript":hex, "watchonly":bool},...]
    ( {"rescan":bool} ) — bulk import (rpcdump.cpp importmulti). One rescan
    at the end regardless of request count."""
    require_params(params, 1, 2, "importmulti requests ( options )")
    if not isinstance(params[0], list):
        raise RPCError(RPC_INVALID_PARAMETER, "requests must be an array")
    options = params[1] if len(params) > 1 and isinstance(params[1], dict) else {}
    do_rescan = bool(options.get("rescan", True))
    from ..crypto.hashes import hash160
    from ..crypto.secp256k1 import pubkey_parse
    from ..script.script import p2pk_script, p2pkh_script_for_pubkey, p2sh_script
    from ..wallet.keys import address_to_script

    w = _wallet(node)
    results = []
    imported_any = False
    for req in params[0]:
        # PHASE 1 — validate and stage everything; no wallet mutation yet,
        # so a mid-request failure can't leave a partial import behind
        try:
            if not isinstance(req, dict):
                raise ValueError("request must be an object")
            if "timestamp" not in req:
                raise ValueError(
                    "Missing required timestamp field for key scan")
            watchonly = req.get("watchonly")
            if watchonly is True and req.get("keys"):
                raise ValueError(
                    "Incompatibility found between watchonly and keys")
            spk_field = req.get("scriptPubKey")
            spk = None
            if isinstance(spk_field, dict) and "address" in spk_field:
                spk = address_to_script(str(spk_field["address"]), node.params)
                if spk is None:
                    raise ValueError("Invalid address")
            elif isinstance(spk_field, str):
                spk = bytes.fromhex(spk_field)
            elif spk_field is not None:
                raise ValueError("Invalid scriptPubKey")

            staged_keys = []
            for wif in req.get("keys", []) or []:
                key = CKey.from_wif(str(wif), node.params)
                if key is None:
                    raise ValueError("Invalid private key encoding")
                staged_keys.append(key)
            staged_scripts = []
            for pk_hex in req.get("pubkeys", []) or []:
                pk = bytes.fromhex(str(pk_hex))
                if pubkey_parse(pk) is None:
                    raise ValueError("Pubkey is not a valid public key")
                staged_scripts.append(p2pk_script(pk))
                staged_scripts.append(p2pkh_script_for_pubkey(pk))
            redeem = req.get("redeemscript")
            if redeem:
                staged_scripts.append(
                    p2sh_script(hash160(bytes.fromhex(str(redeem)))))
            if spk is not None and not staged_keys:
                staged_scripts.append(spk)
            if not staged_keys and not staged_scripts:
                raise ValueError("Request contains nothing to import")
        except (ValueError, WalletError) as e:
            results.append({"success": False,
                            "error": {"code": RPC_INVALID_ADDRESS_OR_KEY,
                                      "message": str(e)}})
            continue
        # PHASE 2 — apply the fully-validated request
        try:
            for key in staged_keys:
                w.add_key(key, persist=False)
        except WalletError as e:  # locked wallet
            results.append({"success": False,
                            "error": {"code": RPC_WALLET_UNLOCK_NEEDED,
                                      "message": str(e)}})
            continue
        w.watched_scripts.update(staged_scripts)
        imported_any = True
        results.append({"success": True})
    if imported_any:
        w.save()
        if do_rescan:
            node._rescan_wallet()
    return results
