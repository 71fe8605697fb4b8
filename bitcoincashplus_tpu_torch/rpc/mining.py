"""Mining RPCs.

Reference: src/rpc/mining.cpp (getblocktemplate :~350, submitblock,
generatetoaddress :~200, getmininginfo, getnetworkhashps,
prioritisetransaction). The nonce search behind generatetoaddress is the
TPU sweep (ops/miner), not the reference's scalar while-loop (SURVEY.md
§4.5) — the RPC surface is identical.
"""

from __future__ import annotations

from ..consensus.block import CBlock
from ..consensus.serialize import hash_to_hex
from ..mining.generate import MAX_TRIES_DEFAULT
from ..wallet.keys import address_to_script
from .blockchain import difficulty_from_bits
from .registry import (
    RPC_DESERIALIZATION_ERROR,
    RPC_INVALID_ADDRESS_OR_KEY,
    RPCError,
    require_params,
    rpc_method,
)


@rpc_method("generatetoaddress")
def generatetoaddress(node, params):
    require_params(params, 2, 3, "generatetoaddress nblocks \"address\" ( maxtries )")
    n_blocks = int(params[0])
    script = address_to_script(params[1], node.params)
    if script is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Error: Invalid address or script")
    max_tries = int(params[2]) if len(params) > 2 else MAX_TRIES_DEFAULT
    hashes = node.generate_to_script(script, n_blocks, max_tries)
    return [hash_to_hex(h) for h in hashes]


@rpc_method("getblocktemplate")
def getblocktemplate(node, params):
    """getblocktemplate (src/rpc/mining.cpp:~350) — BIP22 shape. A
    template_request with 'longpollid' blocks (~60s max) until the tip or
    the mempool changes, like the reference's checktxtime/hashWatchedChain
    wait loop."""
    request = params[0] if params and isinstance(params[0], dict) else {}
    if request.get("mode") == "proposal":
        # BIP22 proposal mode: validate a block against the current tip
        # without submitting it (TestBlockValidity; rpc/mining.cpp)
        try:
            block = CBlock.from_bytes(bytes.fromhex(request.get("data", "")))
        except Exception:
            raise RPCError(RPC_DESERIALIZATION_ERROR,
                           "Block decode failed") from None
        with node.cs_main:
            cs = node.chainstate
            if block.header.hash_prev_block != cs.tip().hash:
                return "inconclusive-not-best-prevblk"
            from ..validation.chainstate import BlockValidationError

            # proposal re-validation rides the signature service: any
            # non-mempool transactions in the proposed block settle
            # through the shared lanes first, so TestBlockValidity's
            # script pass is sigcache hits (serving/sigservice).
            # require_pow=False: proposals are legitimately unmined and
            # the RPC surface is local/authenticated; the merkle gate
            # inside prewarm still applies
            if getattr(node, "sigservice", None) is not None:
                from ..serving import prewarm_block_sigs

                prewarm_block_sigs(node, block, require_pow=False)
            try:
                cs.test_block_validity(block)
            except BlockValidationError as e:
                return e.reason
        return None
    longpollid = request.get("longpollid")
    if longpollid:
        def changed():
            tip = node.chainstate.tip()
            cur = hash_to_hex(tip.hash) + f"{node.mempool.sequence}"
            return True if cur != longpollid else None

        node.wait_for(changed, timeout=60.0)
    with node.cs_main:
        return _template_json(node)


getblocktemplate.no_cs_main = True


def _template_json(node):
    tmpl = node.assembler().create_new_block(script_pubkey=b"\x51")  # OP_TRUE placeholder
    block = tmpl.block
    cs = node.chainstate
    tip = cs.tip()
    txs = []
    txid_to_pos = {}
    for i, tx in enumerate(block.vtx[1:], start=1):
        txid_to_pos[tx.txid] = i
        depends = sorted(
            txid_to_pos[vin.prevout.hash]
            for vin in tx.vin
            if vin.prevout.hash in txid_to_pos
        )
        txs.append({
            "data": tx.serialize().hex(),
            "txid": tx.txid_hex,
            "hash": tx.txid_hex,
            "depends": depends,
            "fee": tmpl.fees[i],
            "sigops": 0,
        })
    return {
        "capabilities": ["proposal"],
        "version": block.header.version,
        "previousblockhash": hash_to_hex(tip.hash),
        "transactions": txs,
        "coinbaseaux": {"flags": ""},
        "coinbasevalue": block.vtx[0].total_output_value(),
        "longpollid": hash_to_hex(tip.hash) + f"{node.mempool.sequence}",
        "target": f"{tmpl.target:064x}",
        "mintime": tip.get_median_time_past() + 1,
        "mutable": ["time", "transactions", "prevblock"],
        "noncerange": "00000000ffffffff",
        "sigoplimit": node.params.max_block_sigops,
        "sizelimit": node.params.max_block_size,
        "curtime": block.header.time,
        "bits": f"{block.header.bits:08x}",
        "height": tmpl.height,
    }


@rpc_method("submitblock")
def submitblock(node, params):
    require_params(params, 1, 2, "submitblock \"hexdata\" ( \"dummy\" )")
    try:
        block = CBlock.from_bytes(bytes.fromhex(params[0]))
    except Exception:
        raise RPCError(RPC_DESERIALIZATION_ERROR, "Block decode failed") from None
    return node.submit_block(block)  # None on success, reason string otherwise


@rpc_method("getmininginfo")
def getmininginfo(node, params):
    cs = node.chainstate
    tip = cs.tip()
    return {
        "blocks": tip.height,
        "currentblocksize": 0,
        "currentblocktx": 0,
        "difficulty": difficulty_from_bits(tip.header.bits),
        "networkhashps": getnetworkhashps(node, []),
        "pooledtx": len(node.mempool),
        "chain": node.params.network,
    }


@rpc_method("getnetworkhashps")
def getnetworkhashps(node, params):
    """GetNetworkHashPS: work over the last nblocks' wall time."""
    n_blocks = int(params[0]) if params else 120
    cs = node.chainstate
    tip = cs.tip()
    if tip is None or tip.height == 0:
        return 0
    n_blocks = min(n_blocks if n_blocks > 0 else tip.height, tip.height)
    first = cs.chain[tip.height - n_blocks]
    time_diff = tip.time - first.time
    if time_diff <= 0:
        return 0
    return (tip.chain_work - first.chain_work) / time_diff


@rpc_method("prioritisetransaction")
def prioritisetransaction(node, params):
    """prioritisetransaction "txid" priority_delta fee_delta — the priority
    delta is accepted-and-ignored (priority was removed from this lineage's
    successor policy); the fee delta (satoshis) feeds mapDeltas."""
    from .registry import require_params

    require_params(params, 3, 3,
                   "prioritisetransaction \"txid\" priority_delta fee_delta")
    from ..consensus.serialize import hex_to_hash

    txid = hex_to_hash(params[0])
    node.mempool.prioritise(txid, int(params[2]))
    return True


@rpc_method("estimatefee")
def estimatefee(node, params):
    """estimatefee (nblocks) — CBlockPolicyEstimator (src/policy/fees.cpp):
    bucketed confirmation tracking with decay; -1 with no data, exactly
    like the reference's cold answer."""
    from ..consensus.tx import COIN

    nblocks = int(params[0]) if params else 1
    est = node.fee_estimator.estimate_fee(max(1, nblocks))
    return -1 if est <= 0 else est / COIN


@rpc_method("estimatesmartfee")
def estimatesmartfee(node, params):
    """estimatesmartfee (conf_target) — honors the target: tries it, then
    widens the horizon, reporting the target that actually answered
    (estimateSmartFee semantics)."""
    from ..consensus.tx import COIN

    nblocks = int(params[0]) if params else 6
    est, answered = node.fee_estimator.estimate_smart_fee(nblocks)
    if est <= 0:
        # smart variant falls back to the relay floor instead of failing
        return {"feerate": node.min_relay_fee_rate / COIN, "blocks": nblocks,
                "errors": ["Insufficient data or no feerate found"]}
    return {"feerate": est / COIN, "blocks": answered}


def _tip_json(node):
    tip = node.chainstate.tip()
    return {"hash": hash_to_hex(tip.hash), "height": tip.height}


@rpc_method("waitfornewblock")
def waitfornewblock(node, params):
    """waitfornewblock ( timeout_ms ) — block until the tip changes."""
    # Core semantics: timeout 0 (or absent) = wait indefinitely
    timeout = (int(params[0]) / 1000) if params and params[0] else float("inf")
    with node.cs_main:
        start = node.chainstate.tip().hash

    node.wait_for(
        lambda: _tip_json(node) if node.chainstate.tip().hash != start else None,
        timeout,
    )
    with node.cs_main:
        return _tip_json(node)


waitfornewblock.no_cs_main = True


@rpc_method("waitforblock")
def waitforblock(node, params):
    """waitforblock "hash" ( timeout_ms )"""
    require_params(params, 1, 2, "waitforblock \"blockhash\" ( timeout )")
    from ..consensus.serialize import hex_to_hash

    target = hex_to_hash(params[0])
    timeout = (int(params[1]) / 1000) if len(params) > 1 and params[1] else float("inf")

    def reached():
        cs = node.chainstate
        idx = cs.block_index.get(target)
        if idx is not None and cs.chain[idx.height] is idx:
            return _tip_json(node)
        return None

    node.wait_for(reached, timeout)
    with node.cs_main:
        return _tip_json(node)


waitforblock.no_cs_main = True


@rpc_method("waitforblockheight")
def waitforblockheight(node, params):
    """waitforblockheight height ( timeout_ms )"""
    require_params(params, 1, 2, "waitforblockheight height ( timeout )")
    height = int(params[0])
    timeout = (int(params[1]) / 1000) if len(params) > 1 and params[1] else float("inf")
    node.wait_for(
        lambda: _tip_json(node) if node.chainstate.tip().height >= height else None,
        timeout,
    )
    with node.cs_main:
        return _tip_json(node)


waitforblockheight.no_cs_main = True


@rpc_method("estimatepriority")
def estimatepriority(node, params):
    """Deprecated priority estimator — always -1, like the reference's
    data-less answer (priority was removed from fee logic)."""
    return -1


@rpc_method("estimatesmartpriority")
def estimatesmartpriority(node, params):
    nblocks = int(params[0]) if params else 6
    return {"priority": -1, "blocks": nblocks,
            "errors": ["Insufficient data or no priority found"]}
