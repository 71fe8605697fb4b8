"""Blockchain RPCs.

Reference: src/rpc/blockchain.cpp (getblockchaininfo, getbestblockhash,
getblockcount, getblockhash, getblock, getblockheader, getdifficulty,
getrawmempool, getmempoolinfo, getmempoolentry, gettxout, gettxoutsetinfo,
invalidateblock, reconsiderblock, verifychain).
"""

from __future__ import annotations

from ..consensus.serialize import hash_to_hex
from ..consensus.tx import COutPoint
from ..validation.chain import BlockStatus
from .rawtransaction import tx_to_json
from .registry import (
    RPC_INVALID_ADDRESS_OR_KEY,
    RPC_INVALID_PARAMETER,
    RPC_MISC_ERROR,
    RPCError,
    param_hash,
    require_params,
    rpc_method,
)


def difficulty_from_bits(bits: int) -> float:
    """GetDifficulty (src/rpc/blockchain.cpp): ratio of the max target
    (0x1d00ffff) to the current target."""
    shift = (bits >> 24) & 0xFF
    diff = 0x0000FFFF / (bits & 0x00FFFFFF)
    while shift < 29:
        diff *= 256.0
        shift += 1
    while shift > 29:
        diff /= 256.0
        shift -= 1
    return diff


def _block_index_or_raise(node, h: bytes):
    idx = node.chainstate.block_index.get(h)
    if idx is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Block not found")
    return idx


def header_to_json(node, idx) -> dict:
    cs = node.chainstate
    nxt = cs.chain.next(idx)
    return {
        "hash": hash_to_hex(idx.hash),
        "confirmations": (cs.chain.height() - idx.height + 1)
        if idx in cs.chain else -1,
        "height": idx.height,
        "version": idx.header.version,
        "versionHex": f"{idx.header.version & 0xFFFFFFFF:08x}",
        "merkleroot": hash_to_hex(idx.header.hash_merkle_root),
        "time": idx.header.time,
        "mediantime": idx.get_median_time_past(),
        "nonce": idx.header.nonce,
        "bits": f"{idx.header.bits:08x}",
        "difficulty": difficulty_from_bits(idx.header.bits),
        "chainwork": f"{idx.chain_work:064x}",
        "previousblockhash": hash_to_hex(idx.prev.hash) if idx.prev else None,
        "nextblockhash": hash_to_hex(nxt.hash) if nxt else None,
    }


@rpc_method("getblockchaininfo")
def getblockchaininfo(node, params):
    cs = node.chainstate
    tip = cs.tip()
    best_header = max(cs.block_index.values(), key=lambda i: i.chain_work)
    out = {
        "chain": node.params.network,
        "blocks": tip.height,
        "headers": best_header.height,
        "bestblockhash": hash_to_hex(tip.hash),
        "difficulty": difficulty_from_bits(tip.header.bits),
        "mediantime": tip.get_median_time_past(),
        "verificationprogress": 1.0,
        "chainwork": f"{tip.chain_work:064x}",
        "pruned": node.prune_mode,
        "softforks": _softforks(node, tip),
    }
    if node.prune_mode:
        # prune_height is tracked incrementally (and persisted) by
        # prune_block_files — no chain scan under cs_main here
        out["pruneheight"] = node.prune_height
    # snapshot-onboarded nodes expose the certificate/quarantine view the
    # fleet probe keys on (serving/replicas.py); absent everywhere else
    snap_info = node.snapshot_info()
    if snap_info is not None:
        out["snapshot"] = snap_info
    return out


def _softforks(node, tip):
    """BIP9 deployment status per getblockchaininfo's bip9_softforks
    (rpc/blockchain.cpp:~1200) + the unknown-version upgrade warning count
    (validation.cpp:~2200)."""
    from ..consensus.versionbits import (
        get_state_for,
        get_state_since_height,
        unknown_version_signalling,
    )

    c = node.params.consensus
    out = {}
    for dep in c.deployments:
        cache = node.versionbits_cache.for_dep(dep)
        state = get_state_for(
            dep, tip, c.miner_confirmation_window,
            c.rule_change_activation_threshold, cache,
        )
        out[dep.name] = {
            "status": state.value,
            "bit": dep.bit,
            "startTime": dep.start_time,
            "timeout": dep.timeout,
            "since": get_state_since_height(
                dep, tip, c.miner_confirmation_window,
                c.rule_change_activation_threshold, cache,
            ),
        }
    out["unknown_versions_last_100"] = unknown_version_signalling(
        tip, c.deployments, c.miner_confirmation_window
    )
    return out


@rpc_method("getbestblockhash")
def getbestblockhash(node, params):
    # settled_tip, not chain.tip(): a block inside the pipelined-IBD settle
    # horizon (signature batch still in flight) is never externalized
    return hash_to_hex(node.chainstate.settled_tip().hash)


@rpc_method("getblockcount")
def getblockcount(node, params):
    # settled height: must agree with getbestblockhash under an open
    # settle horizon (a speculative block may still unwind)
    return node.chainstate.settled_tip().height


@rpc_method("getblockhash")
def getblockhash(node, params):
    require_params(params, 1, 1, "getblockhash height")
    height = int(params[0])
    idx = node.chainstate.chain[height]
    if idx is None or height > node.chainstate.settled_tip().height:
        raise RPCError(RPC_INVALID_PARAMETER, "Block height out of range")
    return hash_to_hex(idx.hash)


@rpc_method("getblockheader")
def getblockheader(node, params):
    require_params(params, 1, 2, "getblockheader \"hash\" ( verbose )")
    h = param_hash(params, 0)
    idx = _block_index_or_raise(node, h)
    verbose = params[1] if len(params) > 1 else True
    if not verbose:
        return idx.header.serialize().hex()
    return header_to_json(node, idx)


@rpc_method("getblock")
def getblock(node, params):
    require_params(params, 1, 2, "getblock \"hash\" ( verbosity )")
    h = param_hash(params, 0)
    idx = _block_index_or_raise(node, h)
    block = node.chainstate.get_block(h)
    if block is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Block not available (no data)")
    verbosity = params[1] if len(params) > 1 else 1
    if isinstance(verbosity, bool):
        verbosity = int(verbosity)
    if verbosity == 0:
        return block.serialize().hex()
    out = header_to_json(node, idx)
    out["size"] = block.size()
    out["nTx"] = len(block.vtx)
    if verbosity == 1:
        out["tx"] = [tx.txid_hex for tx in block.vtx]
    else:
        out["tx"] = [tx_to_json(node, tx) for tx in block.vtx]
    return out


@rpc_method("getdifficulty")
def getdifficulty(node, params):
    return difficulty_from_bits(node.chainstate.tip().header.bits)


@rpc_method("getchaintips")
def getchaintips(node, params):
    """getchaintips (src/rpc/blockchain.cpp): every fork tip + its status."""
    cs = node.chainstate
    has_child = {idx.prev for idx in cs.block_index.values() if idx.prev}
    tips = [i for i in cs.block_index.values() if i not in has_child]
    out = []
    for idx in tips:
        fork = cs.chain.find_fork(idx)
        branch_len = idx.height - (fork.height if fork else 0)
        if idx in cs.chain:
            status = "active"
        elif idx.status & BlockStatus.FAILED_MASK:
            status = "invalid"
        elif idx.chain_tx == 0:
            status = "headers-only"
        elif idx.is_valid(BlockStatus.VALID_SCRIPTS):
            status = "valid-fork"
        else:
            status = "valid-headers"
        out.append({
            "height": idx.height,
            "hash": hash_to_hex(idx.hash),
            "branchlen": branch_len,
            "status": status,
        })
    return out


@rpc_method("getrawmempool")
def getrawmempool(node, params):
    verbose = params[0] if params else False
    pool = node.mempool
    if not verbose:
        return [hash_to_hex(txid) for txid in pool.entries]
    return {hash_to_hex(txid): _mempool_entry_json(pool, e)
            for txid, e in pool.entries.items()}


def _mempool_entry_json(pool, e) -> dict:
    return {
        "size": e.size,
        "fee": e.base_fee / 1e8,
        "modifiedfee": e.fee / 1e8,
        "time": e.time,
        "height": e.entry_height,
        "descendantcount": e.count_with_descendants,
        "descendantsize": e.size_with_descendants,
        "descendantfees": e.fees_with_descendants,
        "ancestorcount": e.count_with_ancestors,
        "ancestorsize": e.size_with_ancestors,
        "ancestorfees": e.fees_with_ancestors,
        "depends": [hash_to_hex(p) for p in pool.parents_in_pool(e.tx)],
    }


@rpc_method("getmempoolentry")
def getmempoolentry(node, params):
    require_params(params, 1, 1, "getmempoolentry \"txid\"")
    txid = param_hash(params, 0)
    e = node.mempool.get(txid)
    if e is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Transaction not in mempool")
    return _mempool_entry_json(node.mempool, e)


@rpc_method("savemempool")
def savemempool(node, params):
    """savemempool — dump the mempool to disk now (mempool.dat)."""
    from ..mempool.persist import dump_mempool

    dump_mempool(node.mempool, node._mempool_dat)
    return None


@rpc_method("getmempoolinfo")
def getmempoolinfo(node, params):
    info = node.mempool.info()
    info["mempoolminfee"] = node.min_relay_fee_rate / 1e8
    # flood-scale perf section (ISSUE 20): batch mode, frontier depths,
    # column occupancy, bulk-evict / fallback / gate tallies
    info["perf"] = node.mempool.perf_snapshot()
    return info


@rpc_method("gettxout")
def gettxout(node, params):
    require_params(params, 2, 3, "gettxout \"txid\" n ( include_mempool )")
    txid = param_hash(params, 0)
    n = int(params[1])
    include_mempool = params[2] if len(params) > 2 else True
    op = COutPoint(txid, n)
    if include_mempool and node.mempool.get_spender(op) is not None:
        return None  # spent by an in-pool tx
    coin = node.chainstate.coins.get_coin(op)
    if coin is None and include_mempool:
        out = node.mempool.get_output(op)
        if out is not None:
            from ..validation.coins import Coin

            coin = Coin(out, 0x7FFFFFFF, False)
    if coin is None:
        return None
    cs = node.chainstate
    return {
        "bestblock": hash_to_hex(cs.tip().hash),
        "confirmations": 0 if coin.height == 0x7FFFFFFF
        else cs.chain.height() - coin.height + 1,
        "value": coin.out.value / 1e8,
        "scriptPubKey": {"hex": coin.out.script_pubkey.hex()},
        "coinbase": coin.is_coinbase,
    }


@rpc_method("gettxoutsetinfo")
def gettxoutsetinfo(node, params):
    cs = node.chainstate
    cs.flush()  # count the persistent set, like the reference's FlushStateToDisk
    total = 0
    n = 0
    for op, coin in _iterate_coins(node):
        n += 1
        total += coin.out.value
    out = {
        "height": cs.chain.height(),
        "bestblock": hash_to_hex(cs.tip().hash),
        "txouts": n,
        "total_amount": total / 1e8,
    }
    # the incremental MuHash set digest (sharded store only — the legacy
    # single-file layout predates accumulator maintenance)
    digest_fn = getattr(node.coins_db, "muhash_digest", None)
    if digest_fn is not None:
        out["muhash"] = digest_fn().hex()
        out["shards"] = node.coins_db.n_shards
        out["epoch"] = node.coins_db.epoch
    return out


def _iterate_coins(node):
    import struct

    from ..validation.coins import Coin

    # facade-uniform iteration (CoinsDB and ShardedCoinsDB both expose
    # iterate_coins) — never reach into a .kv that sharded stores lack
    for k36, v in node.coins_db.iterate_coins():
        op = COutPoint(k36[:32], struct.unpack("<I", k36[32:36])[0])
        yield op, Coin.deserialize(v)


@rpc_method("dumptxoutset")
def dumptxoutset(node, params):
    require_params(params, 1, 1, "dumptxoutset \"path\"")
    cs = node.chainstate
    cs.flush()  # the snapshot is cut from the PERSISTED set
    tip = cs.tip()
    headers = [cs.chain[h].header.serialize() for h in range(tip.height + 1)]
    from ..store import snapshot as snapshot_mod

    # proof-carrying certificate: built from this node's own undo data
    # (store/certificate.py). A node that cannot attest — legacy store,
    # or itself snapshot-onboarded without full backfill — dumps an
    # uncertified snapshot with a warning rather than failing the dump.
    from ..store.certificate import CertificateError
    from ..util.log import log_printf

    certificate = None
    try:
        certificate = node.build_snapshot_certificate(tip.height)
    except CertificateError as e:
        log_printf("dumptxoutset: cannot attest (%s) — writing an "
                   "UNCERTIFIED snapshot; loaders will quarantine it "
                   "until fully validated", e)

    manifest = snapshot_mod.dump_snapshot(
        node.coins_db, str(params[0]), headers, tip.height, tip.hash,
        node.params.network, certificate=certificate)
    return {
        "path": str(params[0]),
        "height": manifest["height"],
        "bestblock": manifest["best_block"],
        "coins": manifest["coins"],
        "muhash": manifest["muhash"],
        "nfiles": len(manifest["files"]),
        "certified": certificate is not None,
        "epochs": len((certificate or {}).get("epochs", [])),
    }


@rpc_method("loadtxoutset")
def loadtxoutset(node, params):
    require_params(params, 1, 1, "loadtxoutset \"path\"")
    from ..store.snapshot import SnapshotError

    try:
        return node.load_utxo_snapshot(str(params[0]))
    except (SnapshotError, ValueError, OSError) as e:
        raise RPCError(RPC_MISC_ERROR, f"loadtxoutset: {e}")


@rpc_method("invalidateblock")
def invalidateblock(node, params):
    require_params(params, 1, 1, "invalidateblock \"hash\"")
    idx = _block_index_or_raise(node, param_hash(params, 0))
    node.chainstate.invalidate_block(idx)
    node.chainstate.flush()
    return None


@rpc_method("reconsiderblock")
def reconsiderblock(node, params):
    require_params(params, 1, 1, "reconsiderblock \"hash\"")
    idx = _block_index_or_raise(node, param_hash(params, 0))
    node.chainstate.reconsider_block(idx)
    node.chainstate.flush()
    return None


@rpc_method("verifychain")
def verifychain(node, params):
    level = int(params[0]) if params else 3
    n_blocks = int(params[1]) if len(params) > 1 else 6
    try:
        return node.verify_db(n_blocks=n_blocks, level=level)
    except Exception:
        return False


@rpc_method("getblockstats")
def getblockstats(node, params):
    """getblockstats (rpc/blockchain.cpp:~1700): per-block fee/size stats.
    Fees come from the block's undo data (spent-coin values), the same
    source the reference uses, so no txindex is needed."""
    require_params(params, 1, 2, "getblockstats hash_or_height ( stats )")
    from ..consensus.params import get_block_subsidy
    from ..validation.coins import BlockUndo

    cs = node.chainstate
    target = params[0]
    if isinstance(target, int) or (isinstance(target, str) and
                                   len(target) != 64):
        idx = cs.chain[int(target)]
        if idx is None:
            raise RPCError(RPC_INVALID_PARAMETER,
                           "Target block height out of range")
    else:
        idx = _block_index_or_raise(node, param_hash(params, 0))
    block = cs.get_block(idx.hash)
    if block is None:
        raise RPCError(RPC_MISC_ERROR, "Block not available")

    raw_undo = node.block_store.get_undo(idx.hash)
    undo = BlockUndo.from_bytes(raw_undo) if raw_undo else None

    fees, feerates, sizes = [], [], []
    ins = outs = total_out = 0
    for t, tx in enumerate(block.vtx[1:]):
        size = len(tx.serialize())
        sizes.append(size)
        ins += len(tx.vin)
        outs += len(tx.vout)
        out_sum = sum(o.value for o in tx.vout)
        total_out += out_sum
        if undo is not None and t < len(undo.vtxundo):
            in_sum = sum(c.out.value for c in undo.vtxundo[t].prevouts)
            fee = in_sum - out_sum
            fees.append(fee)
            if size:
                feerates.append(fee * 1000 // size)
    outs += len(block.vtx[0].vout)
    total_out += sum(o.value for o in block.vtx[0].vout)

    def med(v):
        return sorted(v)[len(v) // 2] if v else 0

    return {
        "blockhash": hash_to_hex(idx.hash),
        "height": idx.height,
        "time": idx.header.time,
        "mediantime": idx.get_median_time_past(),
        "txs": len(block.vtx),
        "ins": ins,
        "outs": outs,
        "subsidy": get_block_subsidy(idx.height, node.params.consensus),
        "totalfee": sum(fees),
        "avgfee": sum(fees) // len(fees) if fees else 0,
        "medianfee": med(fees),
        "minfee": min(fees) if fees else 0,
        "maxfee": max(fees) if fees else 0,
        "avgfeerate": sum(feerates) // len(feerates) if feerates else 0,
        "medianfeerate": med(feerates),
        "minfeerate": min(feerates) if feerates else 0,
        "maxfeerate": max(feerates) if feerates else 0,
        "total_size": sum(sizes),
        "avgtxsize": sum(sizes) // len(sizes) if sizes else 0,
        "mediantxsize": med(sizes),
        "mintxsize": min(sizes) if sizes else 0,
        "maxtxsize": max(sizes) if sizes else 0,
        "total_out": total_out,
    }


@rpc_method("getmempoolancestors")
def getmempoolancestors(node, params):
    """getmempoolancestors (rpc/blockchain.cpp): in-pool ancestors of a
    mempool tx, txid list or verbose entry map."""
    require_params(params, 1, 2, "getmempoolancestors \"txid\" ( verbose )")
    txid = param_hash(params, 0)
    pool = node.mempool
    if txid not in pool.entries:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Transaction not in mempool")
    anc = pool.calculate_ancestors(pool.entries[txid].tx) - {txid}
    verbose = params[1] if len(params) > 1 else False
    if not verbose:
        return [hash_to_hex(t) for t in sorted(anc)]
    return {hash_to_hex(t): _mempool_entry_json(pool, pool.entries[t])
            for t in anc}


@rpc_method("getmempooldescendants")
def getmempooldescendants(node, params):
    require_params(params, 1, 2, "getmempooldescendants \"txid\" ( verbose )")
    txid = param_hash(params, 0)
    pool = node.mempool
    if txid not in pool.entries:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY,
                       "Transaction not in mempool")
    desc = pool.calculate_descendants(txid) - {txid}
    verbose = params[1] if len(params) > 1 else False
    if not verbose:
        return [hash_to_hex(t) for t in sorted(desc)]
    return {hash_to_hex(t): _mempool_entry_json(pool, pool.entries[t])
            for t in desc}


@rpc_method("preciousblock")
def preciousblock(node, params):
    """preciousblock \"hash\": prefer this block over equal-work
    competitors (validation.cpp PreciousBlock)."""
    require_params(params, 1, 1, "preciousblock \"blockhash\"")
    idx = _block_index_or_raise(node, param_hash(params, 0))
    node.chainstate.precious_block(idx)
    return None


@rpc_method("getchaintxstats")
def getchaintxstats(node, params):
    """getchaintxstats ( nblocks "blockhash" ) — tx rate over a window
    ending at the given block (src/rpc/blockchain.cpp)."""
    cs = node.chainstate
    final = cs.tip()
    if len(params) > 1 and params[1]:
        final = _block_index_or_raise(node, param_hash(params, 1))
        if cs.chain[final.height] is not final:
            raise RPCError(RPC_INVALID_PARAMETER,
                           "Block is not in main chain")
    # default window: one month of target spacing, clamped to the chain
    spacing = node.params.consensus.pow_target_spacing
    if params and params[0] is not None:
        window = int(params[0])
    else:
        window = max(0, min(final.height - 1, 30 * 24 * 3600 // spacing))
    # Core's bound: 0 <= blockcount < height (0 = totals only)
    if window < 0 or (window > 0 and window >= final.height):
        raise RPCError(RPC_INVALID_PARAMETER,
                       "Invalid block count: should be between 0 and the "
                       "block's height - 1")
    out = {
        "time": final.header.time,
        "txcount": final.chain_tx,
        "window_final_block_hash": hash_to_hex(final.hash),
        "window_block_count": window,
    }
    if window > 0:
        first = cs.chain[final.height - window]
        interval = final.get_median_time_past() - first.get_median_time_past()
        out["window_tx_count"] = final.chain_tx - first.chain_tx
        out["window_interval"] = interval
        if interval > 0:
            out["txrate"] = (final.chain_tx - first.chain_tx) / interval
    return out


@rpc_method("pruneblockchain")
def pruneblockchain(node, params):
    """pruneblockchain height — manual prune (requires -prune=1)."""
    require_params(params, 1, 1, "pruneblockchain height")
    if not node.prune_mode:
        raise RPCError(RPC_MISC_ERROR,
                       "Cannot prune blocks because node is not in prune "
                       "mode.")
    height = int(params[0])
    tip = node.chainstate.tip().height
    if height < 0 or height > tip:
        raise RPCError(RPC_INVALID_PARAMETER,
                       "Blockchain block height out of range")
    node.prune_block_files(height)
    return node.prune_height
