"""bcp-cli — command-line RPC client.

Reference: src/bitcoin-cli.cpp: flags mirror bcpd's (-datadir, -regtest,
-rpcport, -rpcuser/-rpcpassword), positionals are `method [params...]`.
JSON-looking params are parsed as JSON, everything else passes as strings
(the reference's univalue coercion behaves the same for our method set).
"""

from __future__ import annotations

import json
import sys

from ..node.config import Config, ConfigError
from ..rpc.client import JSONRPCException, RPCClient


def _coerce(value: str):
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    config = Config()
    positionals = []
    for arg in argv:
        if arg.startswith("-") and not positionals:
            try:
                config.parse_args([arg])
            except ConfigError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        else:
            positionals.append(arg)
    if not positionals:
        print("usage: bcp-cli [options] <method> [params...]", file=sys.stderr)
        return 1
    config.read_config_file()
    params = config.chain_params()
    client = RPCClient(
        host=config.get("rpcconnect", "127.0.0.1"),
        port=config.rpc_port(params),
        user=config.get("rpcuser"),
        password=config.get("rpcpassword"),
        datadir=None if config.get("rpcuser") else config.datadir,
    )
    method, *raw_params = positionals
    try:
        result = client.call(method, *(_coerce(p) for p in raw_params))
    except JSONRPCException as e:
        print(f"error code: {e.code}\nerror message:\n{e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"error: couldn't connect to server: {e}", file=sys.stderr)
        return 1
    if isinstance(result, (dict, list)):
        print(json.dumps(result, indent=2))
    elif result is None:
        pass
    else:
        print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
