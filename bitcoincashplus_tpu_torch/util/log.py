"""Category-gated logging — the LogPrintf / LogPrint(category, ...) system.

Reference: src/util.cpp (LogPrintf, LogPrint, LogAcceptCategory,
OpenDebugLog, fPrintToConsole). `-debug=<cat>` gates category logs;
`-debug=1`/`-debug=all` enables everything. Unconditional logs
(log_printf) always reach debug.log once initialized.

Categories used in this framework (superset of the reference's that apply):
  net, mempool, rpc, bench, db, validation, tpu

Structured mode (`-logjson`): each record is one JSON object per line
(`{"ts", "msg", "cat", "corr"}`) instead of the classic text line. `corr`
is the active telemetry span's correlation id (util/telemetry) when span
tracing is on — logs and -tracefile dumps cross-reference through it, so
"which block's settle emitted this warning" is a join, not a guess.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import IO, Iterable, Optional

_lock = threading.Lock()
_logfile: Optional[IO[str]] = None
_categories: set[str] = set()
_all_categories = False
_print_to_console = False
_json_mode = False
_started = time.time()


def log_init(logfile_path: Optional[str] = None,
             categories: Iterable[str] = (),
             print_to_console: bool = False,
             json_mode: bool = False) -> None:
    """InitLogging + OpenDebugLog. Safe to call more than once (tests)."""
    global _logfile, _all_categories, _print_to_console, _json_mode
    with _lock:
        if _logfile is not None:
            try:
                _logfile.close()
            except OSError:
                pass
            _logfile = None
        _categories.clear()
        _all_categories = False
        _print_to_console = print_to_console
        _json_mode = json_mode
        for cat in categories:
            if cat in ("1", "all"):
                _all_categories = True
            elif cat.startswith("-") or cat == "0":
                pass  # -debug=0 / exclusion: keep disabled
            else:
                _categories.add(cat)
        if logfile_path:
            os.makedirs(os.path.dirname(logfile_path) or ".", exist_ok=True)
            _logfile = open(logfile_path, "a", buffering=1)


def log_accept_category(category: str) -> bool:
    """LogAcceptCategory (src/util.cpp)."""
    return _all_categories or category in _categories


def _emit(line: str, category: Optional[str] = None) -> None:
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    if _json_mode:
        rec = {"ts": stamp, "msg": line}
        if category is not None:
            rec["cat"] = category
        try:
            from . import telemetry

            corr = telemetry.current_corr()
            if corr is not None:
                rec["corr"] = corr
        except Exception:  # telemetry must never take logging down
            pass
        out = json.dumps(rec) + "\n"
    else:
        out = f"{stamp} {line}\n"
    with _lock:
        if _logfile is not None:
            _logfile.write(out)
        if _print_to_console or _logfile is None:
            sys.stderr.write(out)
            sys.stderr.flush()


def log_printf(msg: str, *args) -> None:
    """LogPrintf — unconditional."""
    _emit(msg % args if args else msg)


def log_print(category: str, msg: str, *args) -> None:
    """LogPrint(category, ...) — emitted only when -debug=<category>."""
    if log_accept_category(category):
        _emit(msg % args if args else msg, category=category)


def uptime() -> int:
    """Seconds since process logging start — `uptime` RPC backend."""
    return int(time.time() - _started)
