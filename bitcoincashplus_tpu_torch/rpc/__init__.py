"""JSON-RPC interface — the capability-parity surface (SURVEY.md §3.1).

Reference: src/rpc/server.cpp (CRPCTable), src/httpserver.cpp,
src/httprpc.cpp, src/rpc/{blockchain,mining,rawtransaction,net,misc}.cpp.
Method names, parameter shapes, and error codes follow the reference; the
transport is Python's stdlib http.server instead of libevent.
"""

from .registry import RPCError, rpc_method, RPC_METHODS  # noqa: F401

# import for registration side effects
from . import blockchain, control, mining, net, rawtransaction, wallet  # noqa: F401,E402
