"""Control / introspection RPCs.

Reference: src/rpc/server.cpp (help, stop, uptime), src/rpc/misc.cpp
(getmemoryinfo, validateaddress). `gettpuinfo` is this framework's own
observability surface (SURVEY.md §6.5): per-dispatch TPU batch stats,
ConnectBlock phase timings, and backend/device identity.
"""

from __future__ import annotations

from ..util.log import uptime as _uptime
from .registry import (
    RPC_METHODS,
    RPC_METHOD_NOT_FOUND,
    RPCError,
    require_params,
    rpc_method,
)


@rpc_method("help")
def help_(node, params):
    if params:
        name = params[0]
        fn = RPC_METHODS.get(name)
        if fn is None:
            raise RPCError(RPC_METHOD_NOT_FOUND, f"help: unknown command: {name}")
        return (fn.__doc__ or name).strip()
    return "\n".join(sorted(RPC_METHODS))


@rpc_method("stop")
def stop(node, params):
    node.stop()
    return "bcpd stopping"


@rpc_method("uptime")
def uptime(node, params):
    import time

    return int(time.time()) - node.start_time


@rpc_method("getmemoryinfo")
def getmemoryinfo(node, params):
    import resource

    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"locked": {"used": usage.ru_maxrss * 1024, "free": 0,
                       "total": usage.ru_maxrss * 1024}}


@rpc_method("verifymessage")
def verifymessage(node, params):
    require_params(params, 3, 3,
                   "verifymessage \"address\" \"signature\" \"message\"")
    from ..wallet.message import verify_message

    return verify_message(str(params[0]), str(params[1]), str(params[2]),
                          node.params)


@rpc_method("signmessagewithprivkey")
def signmessagewithprivkey(node, params):
    require_params(params, 2, 2,
                   "signmessagewithprivkey \"privkey\" \"message\"")
    from ..wallet.keys import CKey
    from ..wallet.message import sign_message
    from .registry import RPC_INVALID_ADDRESS_OR_KEY

    key = CKey.from_wif(str(params[0]), node.params)
    if key is None:
        raise RPCError(RPC_INVALID_ADDRESS_OR_KEY, "Invalid private key")
    return sign_message(key, str(params[1]))


@rpc_method("validateaddress")
def validateaddress(node, params):
    require_params(params, 1, 1, "validateaddress \"address\"")
    from ..wallet.keys import address_to_script

    script = address_to_script(params[0], node.params)
    if script is None:
        return {"isvalid": False}
    return {
        "isvalid": True,
        "address": params[0],
        "scriptPubKey": script.hex(),
    }


@rpc_method("gettpuinfo")
def gettpuinfo(node, params):
    """TPU observability: ECDSA batch-dispatch stats (ops/ecdsa_batch.STATS),
    supervised-dispatch circuit-breaker state per subsystem (ops/dispatch:
    state, trip counts, fallback call/item tallies — fallback_items is sigs
    for ecdsa, hashes for sha256, leaves for merkle), the active
    fault-injection config (BCP_FAULT_*), sigcache hit/insert/eviction
    rates, the device-resident mining loop (``mining``: active sweep
    engine, template generation, tiles swept, candidate FIFO depth/hits,
    buffer-swap count, poll cadence — mining/resident.py),
    ConnectBlock phase timings (-debug=bench counters), the
    pipelined-IBD settle horizon (``pipeline``: depth/occupancy, per-leg
    times, unwind count, cross-block lane fill and overlap fraction, and
    the speculation tree's live shape under ``pipeline.tree`` — branches,
    layers, drops, reorg depth, collapse level), the
    BIP30 pre-scan fast-path counters (``bip30``), the active
    backend/device, the always-on signature service (``serving``: flush
    reasons, queue depth, dedup/cache hits, import-priority preemptions,
    enqueue->verdict wait quantiles), and — when P2P is running — the
    peer-supervision ledger (``net``: misbehavior charges, discharge
    reasons, stall re-requests, flood charges, orphan pool accounting,
    banlist size), plus the sharded chainstate store (``store``: shard
    fan-out, commit epoch, MuHash set digest, last parallel flush,
    assumeutxo snapshot progress — store/sharded.py), and — when the
    fleet front door is up — the gateway (``gateway``: admission/shed/
    coalesce/failover tallies and the replica rotation with per-replica
    breaker state and probed tips — serving/gateway.py)."""
    from ..ops import dispatch, ecdsa_batch
    from ..util import faults

    stats = ecdsa_batch.STATS.snapshot()
    devices = ecdsa_batch.device_names()
    from ..mempool.accept import accept_latency_quantiles, accept_stage_quantiles
    from ..mining.assembler import template_build_quantiles
    from ..util import devicewatch, lockwatch, telemetry

    return {
        "backend": node.backend,
        "devices": devices,
        # active verify-kernel selection (-ecdsakernel) + GLV health: the
        # fixed-base comb build cost (0.0 until the first GLV dispatch
        # builds it), host decompose/pack stage times, fallback tallies
        "ecdsa": ecdsa_batch.kernel_info(),
        "batch": stats,
        "breakers": dispatch.snapshot(),
        "faults": faults.INJECTOR.snapshot(),
        "sigcache": node.sigcache.snapshot(),
        # flood-scale mempool (ISSUE 20): frontier depth, column-sync
        # tallies, bulk-evict episodes, fallback/differential-gate
        # verdicts, plus the per-stage accept and template-build p50/p99;
        # getattr-guarded for harness stubs that pass a bare namespace
        "mempool": ({**node.mempool.perf_snapshot(),
                     "accept_stages": accept_stage_quantiles(),
                     "template_build": template_build_quantiles()}
                    if hasattr(getattr(node, "mempool", None),
                               "perf_snapshot") else {}),
        # the device-resident mining loop (mining/resident): sweep engine
        # selection + resident-loop state; getattr-guarded for harness
        # stubs that pass a bare node namespace
        "mining": (node.mining_snapshot()
                   if hasattr(node, "mining_snapshot") else {}),
        "connectblock": dict(node.chainstate.bench),
        # getattr-guarded: harness stubs pass a bare chainstate namespace
        "pipeline": (node.chainstate.pipeline_snapshot()
                     if hasattr(node.chainstate, "pipeline_snapshot")
                     else {}),
        "bip30": dict(getattr(node.chainstate, "bip30_stats", {})),
        # the sharded chainstate facade (store/sharded): fan-out, commit
        # epoch, set digest, last parallel flush, assumeutxo progress;
        # getattr-guarded for harness stubs and legacy single-file nodes
        "store": (node.store_info()
                  if hasattr(node, "store_info") else {}),
        "net": (node.connman.net_snapshot()
                if getattr(node, "connman", None) is not None else {}),
        # the always-on signature service (serving/sigservice): flush
        # reasons, queue depth, dedup/cache hits, preemptions, and the
        # enqueue->verdict wait quantiles; {"enabled": False} when
        # -sigservice=off
        "serving": (node.sigservice.snapshot()
                    if getattr(node, "sigservice", None) is not None
                    else {"enabled": False}),
        # fleet serving front door (serving/gateway): admission/shed/
        # coalesce/failover tallies plus the replica rotation (per-replica
        # breaker state, probed tip, lag verdict); {"enabled": False}
        # unless -gateway is up
        "gateway": ({"enabled": True, **node.gateway.snapshot()}
                    if getattr(node, "gateway", None) is not None
                    else {"enabled": False}),
        # unified-telemetry view (util/telemetry): the active level, span
        # ring-buffer occupancy, and the serving path's p50/p90/p99
        # mempool accept latency (the registry's histogram — getmetrics /
        # /metrics expose the full distribution)
        "telemetry": {
            "mode": telemetry.mode(),
            "spans": telemetry.TRACER.stats(),
            "accept_latency": accept_latency_quantiles(),
        },
        # device-lane monitor (util/devicewatch): per-program compile
        # counts + distinct-shape signatures vs declared budgets (+ any
        # first-compile cost-analysis FLOPs/bytes), host<->device
        # transfer byte totals per site, profiler state, and the stall
        # watchdog
        "device": devicewatch.snapshot(),
        # runtime lock-order sentinel (util/lockwatch): locks watched,
        # acquisition counts, max held-depth, the live ordering edges,
        # and any inversions/cycles; {"enabled": False} unless the
        # process runs with BCP_LOCKWATCH=1
        "lockwatch": lockwatch.snapshot(),
    }


@rpc_method("getmetrics")
def getmetrics(node, params):
    """getmetrics

    The unified telemetry registry (util/telemetry): every counter/gauge/
    histogram family — native metrics plus the collector-projected STATS,
    breaker, sigcache, pipeline, and net surfaces — with histogram bucket
    counts and p50/p90/p99 estimates inline. The same namespace Prometheus
    scrapes at /metrics on the REST server."""
    from ..util import telemetry

    return telemetry.REGISTRY.snapshot()


@rpc_method("dumptrace")
def dumptrace(node, params):
    """dumptrace ( "path" )

    Write the span tracer's ring buffer as Chrome-trace/perfetto JSON
    (load at ui.perfetto.dev). Default path: <datadir>/trace.json.
    Returns {path, events, mode} — with -telemetry below `trace` the
    buffer is empty and the dump says so rather than erroring."""
    import os as _os

    from ..util import telemetry

    path = str(params[0]) if params else _os.path.join(node.datadir,
                                                       "trace.json")
    events = telemetry.TRACER.dump(path)
    return {"path": path, "events": events, "mode": telemetry.mode()}


@rpc_method("startprofile")
def startprofile(node, params):
    """startprofile ( "dir" )

    Start an on-demand torch.profiler trace (host and CUDA activity, the
    card's kernels by name — the layer below the span tracer's host
    view). Default directory: <datadir>/profile. Stop with
    ``stopprofile``; the dump is a Chrome trace, <dir>/trace.json (load
    at ui.perfetto.dev or chrome://tracing). Errors if a profile is
    already running (the profiler is process-global)."""
    import os as _os

    from ..util import devicewatch
    from .registry import RPC_INVALID_PARAMETER, RPC_MISC_ERROR

    path = str(params[0]) if params else _os.path.join(node.datadir,
                                                       "profile")
    try:
        return devicewatch.start_profile(path)
    except RuntimeError as e:
        raise RPCError(RPC_INVALID_PARAMETER, str(e)) from None
    except Exception as e:  # noqa: BLE001 — backend/profiler failure
        raise RPCError(RPC_MISC_ERROR,
                       f"startprofile failed: {type(e).__name__}: {e}"
                       ) from None


@rpc_method("stopprofile")
def stopprofile(node, params):
    """stopprofile

    Stop the running torch.profiler trace started by ``startprofile``;
    returns {path, seconds}. Errors if no profile is running."""
    from ..util import devicewatch
    from .registry import RPC_INVALID_PARAMETER, RPC_MISC_ERROR

    try:
        return devicewatch.stop_profile()
    except RuntimeError as e:
        raise RPCError(RPC_INVALID_PARAMETER, str(e)) from None
    except Exception as e:  # noqa: BLE001 — backend/profiler failure
        raise RPCError(RPC_MISC_ERROR,
                       f"stopprofile failed: {type(e).__name__}: {e}"
                       ) from None


@rpc_method("createmultisig")
def createmultisig(node, params):
    """createmultisig nrequired ["key",...] — address + redeemScript
    (src/rpc/misc.cpp). Keys must be hex pubkeys (no wallet lookup)."""
    require_params(params, 2, 2, "createmultisig nrequired [\"key\",...]")
    from ..crypto.hashes import hash160
    from ..script.script import p2sh_script
    from ..wallet.keys import script_to_address
    from .wallet import _parse_multisig_params

    m, redeem = _parse_multisig_params(node, None, params)
    return {
        "address": script_to_address(p2sh_script(hash160(redeem)),
                                     node.params),
        "redeemScript": redeem.hex(),
    }


@rpc_method("getinfo")
def getinfo(node, params):
    """getinfo — the classic aggregated snapshot (src/rpc/misc.cpp; still
    present in this lineage, deprecated later)."""
    from ..consensus.tx import COIN
    from .blockchain import difficulty_from_bits

    tip = node.chainstate.tip()
    out = {
        "version": 140000,
        "protocolversion": 70015,
        "blocks": tip.height,
        "timeoffset": 0,
        "connections": (len(node.connman.peers)
                        if node.connman is not None else 0),
        "proxy": "",
        "difficulty": difficulty_from_bits(tip.header.bits),
        "testnet": node.params.network == "test",
        "chain": node.params.network,
        "relayfee": node.min_relay_fee_rate / COIN,
        "errors": "",
    }
    if node.wallet is not None:
        out["walletversion"] = 2
        out["balance"] = node.wallet.balance(tip.height) / COIN
        out["keypoololdest"] = 0
        out["keypoolsize"] = len(node.wallet.keys_by_pubkey)
        if node.wallet.is_crypted:
            out["unlocked_until"] = (0 if node.wallet.is_locked
                                     else int(node.wallet.unlocked_until))
    return out
