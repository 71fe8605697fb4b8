"""HTTP JSON-RPC server.

Reference: src/httpserver.cpp (StartHTTPServer — libevent evhttp + a worker
queue; here ThreadingHTTPServer gives the same request-per-thread shape),
src/httprpc.cpp (HTTPReq_JSONRPC: basic auth, single + batch requests),
src/rpc/protocol.cpp (GenerateAuthCookie — the `.cookie` file contract that
bitcoin-cli and the functional framework rely on).

All handlers run under node.cs_main — the RPC layer is the reference's
"everything takes cs_main" model, minus the footguns.
"""

from __future__ import annotations

import base64
import json
import os
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..util.log import log_print, log_printf
from .registry import (
    RPC_INTERNAL_ERROR,
    RPC_INVALID_REQUEST,
    RPC_METHOD_NOT_FOUND,
    RPC_PARSE_ERROR,
    RPC_METHODS,
    RPCError,
)

COOKIE_USER = "__cookie__"


def generate_auth_cookie(datadir: str) -> str:
    """GenerateAuthCookie (src/rpc/protocol.cpp): random credential written
    to <datadir>/.cookie as `__cookie__:<hex>`."""
    password = secrets.token_hex(32)
    path = os.path.join(datadir, ".cookie")
    with open(path, "w") as f:
        f.write(f"{COOKIE_USER}:{password}")
    os.chmod(path, 0o600)
    return password


class RPCServer:
    def __init__(self, node, bind: str = "127.0.0.1", port: int = 0):
        self.node = node
        user = node.config.get("rpcuser")
        password = node.config.get("rpcpassword")
        if not (user and password):
            user, password = COOKIE_USER, generate_auth_cookie(node.datadir)
        self._auth = base64.b64encode(f"{user}:{password}".encode()).decode()
        self._httpd = ThreadingHTTPServer((bind, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rpc", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        cookie = os.path.join(self.node.datadir, ".cookie")
        if os.path.exists(cookie):
            os.remove(cookie)

    # -- dispatch -------------------------------------------------------

    def execute(self, request: dict) -> dict:
        """CRPCTable::execute — one JSON-RPC call object to one response."""
        req_id = request.get("id")
        method = request.get("method")
        params = request.get("params") or []
        if not isinstance(method, str) or not isinstance(params, list):
            return _error_obj(req_id, RPC_INVALID_REQUEST, "Invalid Request")
        handler = RPC_METHODS.get(method)
        if handler is None:
            return _error_obj(req_id, RPC_METHOD_NOT_FOUND, "Method not found")
        log_print("rpc", "ThreadRPCServer method=%s", method)
        try:
            if getattr(handler, "no_cs_main", False):
                # blocking handlers (longpoll, waitfor*) manage cs_main
                # themselves so other RPC threads aren't starved
                result = handler(self.node, params)
            else:
                with self.node.cs_main:
                    result = handler(self.node, params)
        except RPCError as e:
            return _error_obj(req_id, e.code, e.message)
        except Exception as e:  # the reference wraps these the same way
            log_printf("RPC internal error in %s: %r", method, e)
            return _error_obj(req_id, RPC_INTERNAL_ERROR, str(e))
        return {"result": result, "error": None, "id": req_id}


def _error_obj(req_id, code: int, message: str) -> dict:
    return {"result": None, "error": {"code": code, "message": message}, "id": req_id}


def _make_handler(server: RPCServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route into our logger
            log_print("rpc", "http: " + fmt, *args)

        def _reply(self, status: int, payload: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            """-rest interface (src/rest.cpp): unauthenticated GET routes,
            enabled by the `rest` config flag; 403 otherwise."""
            from .rest import RestError, handle_rest

            if not server.node.config.get_bool("rest"):
                payload = b"REST interface disabled (enable with -rest)\n"
                self.send_response(403)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            try:
                status, ctype, body = handle_rest(server.node, self.path)
            except RestError as e:
                status, ctype = e.status, "text/plain"
                body = (e.message + "\r\n").encode()
            except Exception as e:  # parity with the POST-side wrapping
                log_printf("REST internal error %s: %r", self.path, e)
                status, ctype, body = 500, "text/plain", b"internal error\r\n"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            auth = self.headers.get("Authorization", "")
            if auth != f"Basic {server._auth}":
                self.send_response(401)
                self.send_header("WWW-Authenticate", 'Basic realm="jsonrpc"')
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length))
            except (ValueError, json.JSONDecodeError):
                self._reply(500, json.dumps(
                    _error_obj(None, RPC_PARSE_ERROR, "Parse error")).encode())
                return
            if isinstance(body, list):  # JSON-RPC batch
                response = [server.execute(req) for req in body]
            else:
                response = server.execute(body)
            status = 200
            if not isinstance(response, list) and response.get("error"):
                code = response["error"]["code"]
                status = 404 if code == RPC_METHOD_NOT_FOUND else 500
            self._reply(status, json.dumps(response).encode())

    return Handler
