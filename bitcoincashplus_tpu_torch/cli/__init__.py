"""Process entry points: bcpd (daemon), bcp-cli (RPC client), bcp-tx
(offline transaction editor).

Reference: src/bitcoind.cpp, src/bitcoin-cli.cpp, src/bitcoin-tx.cpp.
Runnable both as installed console scripts and as modules
(`python -m bitcoincashplus_tpu.cli.bcpd`).
"""
