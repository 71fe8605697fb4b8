"""Node runtime — process lifecycle, flags, the AppInitMain analogue.

Reference: src/bitcoind.cpp, src/init.cpp, src/util.cpp (ArgsManager-style
flag handling). The `--tpu` backend switch lives here (SURVEY.md §6.6).
"""

from .config import Config  # noqa: F401
from .node import Node  # noqa: F401
