"""bcpd — the daemon entry point.

Reference: src/bitcoind.cpp (main → AppInit → AppInitMain → run until
StartShutdown). SIGINT/SIGTERM trigger the same orderly shutdown as the
`stop` RPC.
"""

from __future__ import annotations

import signal
import sys

from ..node.config import HELP_MESSAGE, Config, ConfigError
from ..node.node import InitError, Node
from ..ops import cuda_build


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    config = Config()
    try:
        config.parse_args(argv)
    except ConfigError as e:
        print(f"Error parsing command line arguments: {e}", file=sys.stderr)
        return 1
    if config.get_bool("?") or config.get_bool("help"):
        print(HELP_MESSAGE)
        return 0
    try:
        config.read_config_file()
    except ConfigError as e:
        print(f"Error reading configuration file: {e}", file=sys.stderr)
        return 1

    # the device the kernels run on: the card unless -device=cpu (the
    # kernels' plain versions, for tests); with no card the daemon raises
    device = config.get("device", "cuda")
    try:
        cuda_build.set_device(device)
    except (ValueError, RuntimeError) as e:  # not cuda or cpu
        print(f"Error parsing command line arguments: -device: {e}",
              file=sys.stderr)
        return 1
    try:
        cuda_build.require_device("bcpd")
        node = Node(config)
    except (InitError, Exception) as e:
        print(f"Error: {e}", file=sys.stderr)
        raise

    def handle_signal(signum, frame):
        node.stop()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)

    if config.get_bool("server", True):
        node.start_rpc()
    if config.get_bool("listen", True) or config.has("connect"):
        try:
            node.start_p2p()
        except Exception as e:
            print(f"P2P disabled: {e}", file=sys.stderr)
    if config.get_int("gateway", 0):
        node.start_gateway()

    print(f"bcpd started: network={node.params.network} datadir={node.datadir}"
          f" device={cuda_build.device()}", flush=True)
    try:
        node.wait_for_shutdown()
    finally:
        node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
