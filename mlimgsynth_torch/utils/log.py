"""Leveled logging matching the reference's logger semantics
(reference: src/ccommon/logging.{h,c}): stderr, ``[MLIS]`` prefix, numeric
levels with relative bumps from the CLI."""
from __future__ import annotations

import sys

LVL_NONE = 0
LVL_ERROR = 10
LVL_WARNING = 20
LVL_INFO = 30
LVL_INFO2 = 35
LVL_VERBOSE = 40
LVL_DEBUG = 50
LVL_MAX = 100

NAMES = {
    "none": LVL_NONE, "error": LVL_ERROR, "warning": LVL_WARNING,
    "info": LVL_INFO, "verbose": LVL_VERBOSE, "debug": LVL_DEBUG,
    "max": LVL_MAX,
}


class Logger:
    def __init__(self, prefix: str = "[MLIS] ", level: int = LVL_INFO):
        self.prefix = prefix
        self.level = level

    def check(self, lvl: int) -> bool:
        return lvl <= self.level

    def log(self, lvl: int, msg: str) -> None:
        if self.check(lvl):
            sys.stderr.write(f"{self.prefix}{msg}\n")
            sys.stderr.flush()

    def error(self, msg: str) -> None:
        self.log(LVL_ERROR, "error: " + msg)

    def warning(self, msg: str) -> None:
        self.log(LVL_WARNING, "warning: " + msg)

    def info(self, msg: str) -> None:
        self.log(LVL_INFO, msg)

    def info2(self, msg: str) -> None:
        self.log(LVL_INFO2, msg)

    def debug(self, msg: str) -> None:
        self.log(LVL_DEBUG, msg)


g_logger = Logger()


def level_from_str(s: str) -> int:
    if s in NAMES:
        return NAMES[s]
    return int(s)
