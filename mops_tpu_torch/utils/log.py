"""Leveled printf-style logger (mirrors reference src/Utils/Log.hpp:25-205;
copy of mops_tpu.utils.log)."""

from __future__ import annotations

import sys
import time

_LEVELS = {"debug": 10, "info": 20, "error": 40}
_level = 20


def set_level(name: str) -> None:
    global _level
    _level = _LEVELS[name.lower()]


def _emit(tag: str, msg: str, *args) -> None:
    ts = time.strftime("%H:%M:%S")
    text = msg % args if args else msg
    print(f"[{ts}][{tag}] {text}", file=sys.stdout)


def debug(msg: str, *args) -> None:
    if _level <= 10:
        _emit("DEBUG", msg, *args)


def info(msg: str, *args) -> None:
    if _level <= 20:
        _emit("INFO", msg, *args)


def error(msg: str, *args) -> None:
    _emit("ERROR", msg, *args)
