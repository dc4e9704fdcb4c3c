"""Logging (port of ``znicz_tpu/core/logger.py``).

Coloured console logging under the ``znicz_torch`` logger, and the
:class:`Logger` mixin every unit takes: it logs under
``znicz_torch.<unit name>``.  :func:`setup_logging` is what the command
line calls first (``python -m znicz_torch``), as the reference's launcher
does.  :class:`timeit` times a block on the host clock.

Unlike the reference's, the ``znicz_torch`` logger keeps propagating to
the root logger, so a process that configured its own root handler (a
test's log capture, an application) still receives the records.
"""

from __future__ import annotations

import logging
import sys
import time

_CONFIGURED = False

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[36m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


class _StderrHandler(logging.StreamHandler):
    """A stream handler on whatever ``sys.stderr`` is when a record comes,
    not the stream it was when the handler was made (that one may be
    closed since: a test's captured stream)."""

    def __init__(self):
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        pass


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def setup_logging(level: int = logging.INFO) -> None:
    """One handler with the coloured formatter on the ``znicz_torch``
    logger, writing to the process's current ``sys.stderr``, at
    ``level``; a second call only sets the level."""
    global _CONFIGURED
    log = logging.getLogger("znicz_torch")
    log.setLevel(level)
    if _CONFIGURED:
        return
    handler = _StderrHandler()
    handler.setFormatter(
        _ColorFormatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                        datefmt="%H:%M:%S"))
    log.addHandler(handler)
    _CONFIGURED = True


class Logger:
    """A logger named after the unit (``znicz_torch.<name>``), and its
    ``debug``/``info``/``warning``/``error``."""

    @property
    def logger(self) -> logging.Logger:
        name = getattr(self, "name", None) or type(self).__name__
        return logging.getLogger(f"znicz_torch.{name}")

    def debug(self, msg: str, *args) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)


class timeit:
    """``with timeit() as t: ...; t.elapsed`` (host seconds)."""

    def __enter__(self) -> "timeit":
        self.start = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.start
