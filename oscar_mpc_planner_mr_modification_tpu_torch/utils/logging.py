"""Leveled, coloured console logging, counterpart of the JAX package's
``utils/logging.py``: one line per message on stderr, a debug gate
(``debug_enabled``) for ``log_debug`` / ``log_mark``, and a throttled
warning on ``time.monotonic``.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

_COLORS = {
    "DEBUG": "\033[36m", "MARK": "\033[35m", "INFO": "\033[32m",
    "WARN": "\033[33m", "ERROR": "\033[31m", "VALUE": "\033[34m",
}
_RESET = "\033[0m"

debug_enabled = False  # the CONFIG["debug_output"] gate
_throttle_last: Dict[str, float] = {}


def _emit(level: str, msg: str) -> None:
    color = _COLORS.get(level, "")
    sys.stderr.write(f"{color}[{level}]{_RESET} {msg}\n")


def log_debug(msg: str) -> None:
    if debug_enabled:
        _emit("DEBUG", msg)


def log_mark(msg: str) -> None:
    """Trace marker, only when debug output is enabled (LOG_MARK semantics)."""
    if debug_enabled:
        _emit("MARK", msg)


def log_info(msg: str) -> None:
    _emit("INFO", msg)


def log_warn(msg: str) -> None:
    _emit("WARN", msg)


def log_error(msg: str) -> None:
    _emit("ERROR", msg)


def log_value(name: str, value) -> None:
    _emit("VALUE", f"{name}: {value}")


def log_warn_throttle(period_ms: float, msg: str) -> None:
    now = time.monotonic()
    last = _throttle_last.get(msg)
    if last is None or (now - last) * 1e3 >= period_ms:
        _throttle_last[msg] = now
        _emit("WARN", msg)


def print_header(title: str) -> None:
    log_info("=" * 10 + f" {title} " + "=" * 10)
