"""Wallet-lite: keys, addresses, transaction signing, coin tracking.

Reference: src/wallet/ (CWallet — ~9k LoC of BDB-backed key management,
coin selection, and signing). This is the capability-parity subset
(SURVEY.md §3.1 "minimal wallet"): enough to mine to an address, track
owned coins, and build/sign spends for e2e tests and RPC — no BDB, no
encryption, no HD gap-limit machinery.
"""

from .keys import CKey, address_to_script, script_to_address  # noqa: F401
from .signing import sign_transaction, SignError  # noqa: F401
from .wallet import Wallet  # noqa: F401
