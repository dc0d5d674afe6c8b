"""Leveled logging — the BL_* macro system as a thin stdlib wrapper.

The reference selects a log engine and verbosity at compile time
(NO_LOG/CERR/PRINTF/… × FATAL…TRACE, /root/reference/src/utils/
logging.h:96-160, CMake wiring CMakeLists.txt:247-328); here one runtime
environment variable ``KMERIND_LOG`` (fatal|error|warning|info|debug|
trace, default warning) configures a standard `logging` logger, and the
level check compiles out of hot paths the same way (module-level guard).
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["log", "set_level", "FATAL", "ERROR", "WARNING", "INFO", "DEBUG",
           "TRACE"]

TRACE = 5
DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
FATAL = logging.CRITICAL

logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "fatal": FATAL, "error": ERROR, "warning": WARNING,
    "info": INFO, "debug": DEBUG, "trace": TRACE, "none": FATAL + 10,
}

log = logging.getLogger("kmerind_jax")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(levelname)s] kmerind_jax %(message)s"))
    log.addHandler(_h)
log.setLevel(_LEVELS.get(
    os.environ.get("KMERIND_LOG", "warning").lower(), WARNING))


def set_level(name: str):
    """Set verbosity by name (the LOGGER_VERBOSITY knob)."""
    log.setLevel(_LEVELS[name.lower()])
