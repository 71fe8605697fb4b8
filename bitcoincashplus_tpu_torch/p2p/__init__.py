"""P2P networking — wire protocol + connection manager.

Reference: src/protocol.{h,cpp} (CMessageHeader, CInv), src/net.{h,cpp}
(CConnman), src/net_processing.cpp (ProcessMessage/SendMessages). Minimal
viable subset (SURVEY.md §3.1 plan): version/verack/ping/pong/inv/getdata/
getheaders/headers/block/tx with the 24-byte SHA256d-checksum framing.
"""

from .protocol import MessageHeader, NetMessageError  # noqa: F401
from .connman import CConnman  # noqa: F401
