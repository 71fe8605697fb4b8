"""Utility layer — logging, time, small shared helpers.

Reference: src/util.{h,cpp}. Kept dependency-free so every layer (consensus,
validation, node) can import it without cycles.
"""

from .log import (  # noqa: F401
    log_accept_category,
    log_init,
    log_print,
    log_printf,
)
