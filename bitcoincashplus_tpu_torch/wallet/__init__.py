"""Keys and transaction signing (host copies), used to sign the
signature-chain workload. The wallet proper is a later slice."""

from .keys import CKey, address_to_script, script_to_address  # noqa: F401
from .signing import sign_transaction, SignError  # noqa: F401
