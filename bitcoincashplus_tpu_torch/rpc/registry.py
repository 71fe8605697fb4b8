"""RPC method table + error model.

Reference: src/rpc/server.cpp (CRPCTable::appendCommand / execute),
src/rpc/protocol.h (the RPC error-code enum — same numeric values here).
"""

from __future__ import annotations

from typing import Callable

# src/rpc/protocol.h
RPC_MISC_ERROR = -1
RPC_TYPE_ERROR = -3
RPC_INVALID_ADDRESS_OR_KEY = -5
RPC_OUT_OF_MEMORY = -7
RPC_INVALID_PARAMETER = -8
RPC_DATABASE_ERROR = -20
RPC_DESERIALIZATION_ERROR = -22
RPC_VERIFY_ERROR = -25
RPC_VERIFY_REJECTED = -26
RPC_VERIFY_ALREADY_IN_CHAIN = -27
RPC_IN_WARMUP = -28
RPC_METHOD_NOT_FOUND = -32601
RPC_INVALID_REQUEST = -32600
RPC_PARSE_ERROR = -32700
RPC_INTERNAL_ERROR = -32603


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


# name -> handler(node, params: list) -> json-serializable result
RPC_METHODS: dict[str, Callable] = {}


def rpc_method(name: str):
    def deco(fn):
        RPC_METHODS[name] = fn
        return fn
    return deco


def require_params(params: list, n_min: int, n_max: int, usage: str):
    if not (n_min <= len(params) <= n_max):
        raise RPCError(RPC_INVALID_PARAMETER, usage)


def param_hash(params: list, i: int) -> bytes:
    """Parse a hex block/tx hash parameter into wire order (little-endian)."""
    from ..consensus.serialize import hex_to_hash

    try:
        h = hex_to_hash(params[i])
    except Exception:
        raise RPCError(RPC_INVALID_PARAMETER,
                       f"parameter {i + 1} must be a 64-character hex hash") from None
    if len(h) != 32:
        raise RPCError(RPC_INVALID_PARAMETER,
                       f"parameter {i + 1} must be a 64-character hex hash")
    return h
