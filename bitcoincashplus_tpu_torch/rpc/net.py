"""Network RPCs.

Reference: src/rpc/net.cpp (getconnectioncount, getpeerinfo, getnettotals,
addnode, getnetworkinfo). Backed by p2p/connman when P2P is running; a
node without P2P reports zero peers, like a -connect=0 reference node.
"""

from __future__ import annotations

from .registry import RPC_INVALID_PARAMETER, RPCError, require_params, rpc_method

PROTOCOL_VERSION = 70015
SUBVERSION = "/bcpd-tpu:0.3.0/"


@rpc_method("getconnectioncount")
def getconnectioncount(node, params):
    return len(node.connman.peers) if node.connman else 0


@rpc_method("getpeerinfo")
def getpeerinfo(node, params):
    """getpeerinfo — per-peer connection stats plus this framework's
    DoS-supervision state: ``banscore`` (misbehavior ledger total),
    ``charges`` (reason -> accumulated score), ``inflight`` (blocks
    getdata'd and not yet received), ``stalling`` (download-timeout flag),
    ``recvrate`` (bytes/sec over the last supervision tick) and
    ``floodstrikes`` (receive-ceiling violations)."""
    if node.connman is None:
        return []
    # snapshot: the event loop evicts peers concurrently (discharges,
    # stall/flood evictions) and a mid-iteration pop would RuntimeError
    return [peer.info() for peer in list(node.connman.peers.values())]


@rpc_method("getnettotals")
def getnettotals(node, params):
    cm = node.connman
    return {
        "totalbytesrecv": cm.bytes_recv if cm else 0,
        "totalbytessent": cm.bytes_sent if cm else 0,
    }


@rpc_method("getnetworkinfo")
def getnetworkinfo(node, params):
    return {
        "version": 30000,
        "subversion": SUBVERSION,
        "protocolversion": PROTOCOL_VERSION,
        "localservices": "0000000000000001",
        "timeoffset": 0,
        "connections": len(node.connman.peers) if node.connman else 0,
        "networkactive": node.connman is not None,
        "relayfee": node.min_relay_fee_rate / 1e8,
        "warnings": "",
    }


@rpc_method("addnode")
def addnode(node, params):
    require_params(params, 2, 2, "addnode \"node\" \"add|remove|onetry\"")
    if node.connman is None:
        raise RPCError(RPC_INVALID_PARAMETER, "P2P is not enabled")
    target, cmd = params[0], params[1]
    if cmd in ("add", "onetry"):
        host, _, port = target.rpartition(":")
        if cmd == "add":
            if target in node.connman.added_nodes:
                raise RPCError(-23, "Error: Node already added")
            node.connman.added_nodes.append(target)
        node.connman.connect_to(host or "127.0.0.1", int(port))
    elif cmd == "remove":
        try:
            node.connman.added_nodes.remove(target)
        except ValueError:
            pass
        node.connman.disconnect(target)
    else:
        raise RPCError(RPC_INVALID_PARAMETER, f"unknown command {cmd!r}")
    return None


@rpc_method("getaddednodeinfo")
def getaddednodeinfo(node, params):
    """getaddednodeinfo — the addnode-list with live-connection status
    (src/rpc/net.cpp getaddednodeinfo). Runs without cs_main: DNS
    resolution of hostname-form targets can block for seconds and must
    not stall validation."""
    if node.connman is None:
        return []
    with node.cs_main:
        targets = list(node.connman.added_nodes)
        peers = {p.addr: p for p in list(node.connman.peers.values())}
    if params and params[-1] and isinstance(params[-1], str):
        if params[-1] not in targets:
            raise RPCError(-24, "Error: Node has not been added.")
        targets = [params[-1]]
    import socket as _socket

    out = []
    for t in targets:
        # resolve a hostname-form target so it matches peer.addr, which
        # records getpeername's numeric ip:port
        host, _, port = t.rpartition(":")
        try:
            resolved = f"{_socket.gethostbyname(host or '127.0.0.1')}:{port}"
        except OSError:
            resolved = t
        peer = peers.get(t) or peers.get(resolved)
        entry = {"addednode": t, "connected": peer is not None,
                 "addresses": []}
        if peer is not None:
            entry["addresses"] = [{
                "address": peer.addr,
                "connected": "inbound" if not peer.outbound else "outbound",
            }]
        out.append(entry)
    return out


getaddednodeinfo.no_cs_main = True


@rpc_method("disconnectnode")
def disconnectnode(node, params):
    require_params(params, 1, 1, "disconnectnode \"address\"")
    if node.connman is not None:
        node.connman.disconnect(params[0])
    return None


@rpc_method("setban")
def setban(node, params):
    """setban "ip" "add|remove" (bantime) — src/rpc/net.cpp:~560, backed by
    the connman ban list (banman.cpp). Host granularity, like peer tracking."""
    require_params(params, 2, 3, "setban \"ip\" \"add|remove\" ( bantime )")
    if node.connman is None:
        raise RPCError(RPC_INVALID_PARAMETER, "P2P networking is disabled")
    ip, cmd = str(params[0]), str(params[1])
    if cmd == "add":
        bantime = int(params[2]) if len(params) > 2 and params[2] else 0
        node.connman.ban(ip, bantime)
    elif cmd == "remove":
        if not node.connman.unban(ip):
            raise RPCError(
                RPC_INVALID_PARAMETER,
                "Error: Unban failed. Requested address/subnet "
                "was not previously banned.",
            )
    else:
        raise RPCError(RPC_INVALID_PARAMETER, f"unknown command {cmd!r}")
    return None


@rpc_method("listbanned")
def listbanned(node, params):
    if node.connman is None:
        return []
    return [
        {"address": ip, "banned_until": int(until)}
        for ip, until in sorted(node.connman.banned().items())
    ]


@rpc_method("clearbanned")
def clearbanned(node, params):
    if node.connman is not None:
        node.connman.clear_banned()
    return None


@rpc_method("ping")
def ping(node, params):
    """Queue a ping to every connected peer (src/rpc/net.cpp ping)."""
    if node.connman is not None:
        node.connman.ping_all()
    return None
