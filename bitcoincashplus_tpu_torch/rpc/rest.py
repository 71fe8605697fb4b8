"""Unauthenticated REST interface — src/rest.cpp (-rest flag).

The reference registers GET handlers on the same evhttp server the JSON-RPC
listener uses; here the RPCServer's request handler routes GETs to
handle_rest when `-rest` is enabled. Same endpoint contract:

  /rest/tx/<txid>.{hex,json}
  /rest/block/<hash>.{hex,json}
  /rest/headers/<count>/<hash>.hex
  /rest/blockhashbyheight/<height>.{hex,json}
  /rest/chaininfo.json
  /rest/mempool/info.json
  /rest/mempool/contents.json

Plus this framework's observability endpoint (not in the reference):

  /metrics   Prometheus text exposition (version 0.0.4) over the unified
             telemetry registry (util/telemetry) — counters, gauges, and
             latency histograms covering dispatch, ecdsa, pipeline,
             sigcache, mempool-accept, and net. Same `-rest` gate as the
             other unauthenticated GETs.

Errors are plain-text with the reference's status codes (400 bad input,
404 unknown object, 403 when -rest is off — callers without auth cookies
use this surface, so it never throws RPC errors outward).
"""

from __future__ import annotations

import json

from ..consensus.serialize import hash_to_hex, hex_to_hash
from .blockchain import (
    _mempool_entry_json,
    getblockchaininfo,
    getmempoolinfo,
    header_to_json,
)
from .rawtransaction import tx_to_json

MAX_REST_HEADERS = 2000


class RestError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_hash(s: str) -> bytes:
    try:
        h = hex_to_hash(s)
    except Exception:
        raise RestError(400, f"Invalid hash: {s}") from None
    if len(h) != 32:
        raise RestError(400, f"Invalid hash: {s}")
    return h


def _split_format(tail: str) -> tuple[str, str]:
    if "." not in tail:
        raise RestError(400, "output format not found (try .json or .hex)")
    base, fmt = tail.rsplit(".", 1)
    if fmt not in ("hex", "json"):
        raise RestError(400, f"output format not supported: .{fmt}")
    return base, fmt


def handle_rest(node, path: str) -> tuple[int, str, bytes]:
    """GET /rest/... (or /metrics) -> (status, content_type, body)."""
    if path == "/metrics" or path.startswith("/metrics?"):
        return handle_metrics(node)
    if not path.startswith("/rest/"):
        raise RestError(404, "not a REST path")
    parts = path[len("/rest/"):].split("/")

    if parts[0].startswith("tx"):
        return _rest_tx(node, parts)
    if parts[0].startswith("block") and not parts[0].startswith("blockhash"):
        return _rest_block(node, parts)
    if parts[0] == "headers" and len(parts) == 3:
        return _rest_headers(node, parts)
    if parts[0].startswith("blockhashbyheight"):
        return _rest_blockhash_by_height(node, parts)
    if parts[0] == "chaininfo.json":
        with node.cs_main:
            return _json(getblockchaininfo(node, []))
    if parts[0].startswith("getutxos"):
        return _rest_getutxos(node, parts)
    if parts[0] == "mempool" and len(parts) == 2:
        if parts[1] == "info.json":
            with node.cs_main:
                return _json(getmempoolinfo(node, []))
        if parts[1] == "contents.json":
            with node.cs_main:
                out = {
                    hash_to_hex(txid): _mempool_entry_json(node.mempool, e)
                    for txid, e in node.mempool.entries.items()
                }
            return _json(out)
    raise RestError(404, f"unknown REST endpoint: {path}")


def handle_metrics(node) -> tuple[int, str, bytes]:
    """GET /metrics — Prometheus text exposition over the telemetry
    registry. Scrape-safe with -telemetry=off too (families expose their
    frozen values; the header names the active mode for operators)."""
    from ..util import telemetry

    body = (f"# bcp telemetry mode={telemetry.mode()}\n"
            + telemetry.REGISTRY.prometheus_text())
    return 200, "text/plain; version=0.0.4; charset=utf-8", body.encode()


def _json(obj) -> tuple[int, str, bytes]:
    return 200, "application/json", (json.dumps(obj) + "\n").encode()


def _hex(raw: bytes) -> tuple[int, str, bytes]:
    return 200, "text/plain", (raw.hex() + "\n").encode()


def _rest_tx(node, parts):
    base, fmt = _split_format(parts[0][len("tx"):].lstrip("/") or
                              (parts[1] if len(parts) > 1 else ""))
    txid = _parse_hash(base)
    with node.cs_main:
        # mempool first, then txindex (the getrawtransaction lookup order)
        tx = node.mempool.get_tx(txid)
        block_hash = None
        if tx is None and node.txindex:
            block_hash = node.txindex_lookup(txid)
            if block_hash is not None:
                block = node.chainstate.get_block(block_hash)
                if block is not None:
                    tx = next((t for t in block.vtx if t.txid == txid), None)
        if tx is None:
            raise RestError(404, f"{base} not found")
        if fmt == "hex":
            return _hex(tx.serialize())
        return _json(tx_to_json(node, tx, block_hash))


def _rest_block(node, parts):
    base, fmt = _split_format(parts[0][len("block"):].lstrip("/") or
                              (parts[1] if len(parts) > 1 else ""))
    h = _parse_hash(base)
    with node.cs_main:
        idx = node.chainstate.block_index.get(h)
        raw = node.block_store.get_block(h)
    if idx is None or raw is None:
        raise RestError(404, f"{base} not found")
    if fmt == "hex":
        return _hex(raw)
    from ..consensus.block import CBlock

    block = CBlock.from_bytes(raw)
    with node.cs_main:
        out = header_to_json(node, idx)
        out["tx"] = [tx_to_json(node, tx) for tx in block.vtx]
    out["size"] = len(raw)
    return _json(out)


def _rest_headers(node, parts):
    try:
        count = int(parts[1])
    except ValueError:
        raise RestError(400, f"invalid count: {parts[1]}") from None
    if not 1 <= count <= MAX_REST_HEADERS:
        raise RestError(400, f"header count out of range: {count}")
    base, fmt = _split_format(parts[2])
    if fmt != "hex":
        raise RestError(400, "output format not supported (headers: .hex)")
    h = _parse_hash(base)
    with node.cs_main:
        cs = node.chainstate
        idx = cs.block_index.get(h)
        headers = []
        while idx is not None and len(headers) < count:
            headers.append(idx.header.serialize())
            idx = cs.chain[idx.height + 1] if cs.chain[idx.height] is idx else None
    if not headers:
        raise RestError(404, f"{base} not found")
    return _hex(b"".join(headers))


def _rest_blockhash_by_height(node, parts):
    base, fmt = _split_format(
        parts[0][len("blockhashbyheight"):].lstrip("/") or
        (parts[1] if len(parts) > 1 else ""))
    try:
        height = int(base)
    except ValueError:
        raise RestError(400, f"invalid height: {base}") from None
    with node.cs_main:
        idx = node.chainstate.chain[height] if height >= 0 else None
    if idx is None:
        raise RestError(404, "block height out of range")
    if fmt == "hex":
        return 200, "text/plain", (hash_to_hex(idx.hash) + "\n").encode()
    return _json({"blockhash": hash_to_hex(idx.hash)})


def _rest_getutxos(node, parts):
    """GET /rest/getutxos[/checkmempool]/<txid>-<n>/....json — UTXO query
    (src/rest.cpp rest_getutxos). JSON output form only."""
    from ..consensus.tx import COutPoint
    from .rawtransaction import script_pubkey_json

    args = list(parts)
    args[-1], fmt = _split_format(args[-1])
    if fmt != "json":
        raise RestError(400, "getutxos supports .json only")
    check_mempool = len(args) > 1 and args[1] == "checkmempool"
    outpoint_parts = args[(2 if check_mempool else 1):]
    if not outpoint_parts or len(outpoint_parts) > 15:  # MAX_GETUTXOS_OUTPOINTS
        raise RestError(400, "expected 1-15 <txid>-<n> outpoints")
    outpoints = []
    for op in outpoint_parts:
        try:
            txid_hex, n = op.rsplit("-", 1)
            outpoints.append(COutPoint(_parse_hash(txid_hex), int(n)))
        except (ValueError, RestError):
            raise RestError(400, f"bad outpoint {op!r}") from None
    with node.cs_main:
        tip = node.chainstate.tip()
        bitmap = []
        utxos = []
        for op in outpoints:
            coin = node.chainstate.coins.get_coin(op)
            spent_in_pool = (check_mempool
                            and node.mempool.get_spender(op) is not None)
            if coin is None and check_mempool:
                out = node.mempool.get_output(op)
                if out is not None and not spent_in_pool:
                    bitmap.append(1)
                    utxos.append({
                        "height": 0x7FFFFFFF,
                        "value": out.value / 1e8,
                        "scriptPubKey": script_pubkey_json(node, out.script_pubkey),
                    })
                    continue
            if coin is None or spent_in_pool:
                bitmap.append(0)
                continue
            bitmap.append(1)
            utxos.append({
                "height": coin.height,
                "value": coin.out.value / 1e8,
                "scriptPubKey": script_pubkey_json(node, coin.out.script_pubkey),
            })
        return _json({
            "chainHeight": tip.height,
            "chaintipHash": hash_to_hex(tip.hash),
            "bitmap": "".join(str(b) for b in bitmap),
            "utxos": utxos,
        })
