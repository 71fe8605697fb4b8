"""Thin JSON-RPC client — the bitcoin-cli / test-framework transport.

Reference: src/bitcoin-cli.cpp (CallRPC: HTTP POST with basic auth from
-rpcuser/-rpcpassword or the datadir `.cookie` file).
"""

from __future__ import annotations

import base64
import http.client
import json
import os
from typing import Optional


class JSONRPCException(Exception):
    def __init__(self, error: dict):
        super().__init__(error.get("message", str(error)))
        self.error = error
        self.code = error.get("code", -1)


def read_cookie(datadir: str) -> tuple[str, str]:
    with open(os.path.join(datadir, ".cookie")) as f:
        user, _, password = f.read().strip().partition(":")
    return user, password


class RPCClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8332,
                 user: str = "", password: str = "",
                 datadir: Optional[str] = None, timeout: float = 120.0):
        if datadir and not (user and password):
            user, password = read_cookie(datadir)
        self.host, self.port, self.timeout = host, port, timeout
        self._auth = base64.b64encode(f"{user}:{password}".encode()).decode()
        self._id = 0

    def call(self, method: str, *params):
        self._id += 1
        payload = json.dumps({
            "jsonrpc": "1.0", "id": self._id,
            "method": method, "params": list(params),
        })
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("POST", "/", payload, {
                "Authorization": f"Basic {self._auth}",
                "Content-Type": "application/json",
            })
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        if body.get("error"):
            raise JSONRPCException(body["error"])
        return body["result"]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *params: self.call(name, *params)
