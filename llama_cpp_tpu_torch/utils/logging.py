"""Runtime logging (reference common/log.{h,cpp} analog).

The reference ships a small leveled logger with ANSI colors, optional
timestamps/prefixes, a --log-file sink, and verbosity thresholds
(common/log.h LOG_INF/WRN/ERR/DBG + common_log_set_*; flags wired in
common/arg.cpp --log-file/--log-colors/--log-timestamps/--log-verbosity).
This is the same surface on Python's logging, used by the server and CLI.

  from llama_cpp_tpu_torch.utils.logging import setup_logging, get_logger
  setup_logging(verbosity=1, colors="auto", logfile="server.log",
                timestamps=True)
  log = get_logger("server")
  log.info("listening on %s:%d", host, port)

Verbosity mapping (reference -lv semantics): <0 errors only, 0 info,
1 debug. Env mirrors: LLAMA_LOG_VERBOSITY / LLAMA_LOG_COLORS /
LLAMA_LOG_TIMESTAMPS / LLAMA_LOG_FILE (same knobs the reference reads
through its arg system).
"""

from __future__ import annotations

import logging
import os
import sys

_COL = {
    logging.DEBUG: "\033[34m",    # blue   (LOG_COL_BLUE)
    logging.INFO: "\033[32m",     # green  (LOG_COL_GREEN)
    logging.WARNING: "\033[33m",  # yellow (LOG_COL_YELLOW)
    logging.ERROR: "\033[31m",    # red    (LOG_COL_RED)
    logging.CRITICAL: "\033[1m\033[31m",
}
_RESET = "\033[0m"
_LETTER = {logging.DEBUG: "D", logging.INFO: "I", logging.WARNING: "W",
           logging.ERROR: "E", logging.CRITICAL: "E"}

ROOT = "llama_cpp_tpu_torch"


class _Formatter(logging.Formatter):
    def __init__(self, colors: bool, timestamps: bool):
        super().__init__()
        self.colors = colors
        self.timestamps = timestamps

    def format(self, record: logging.LogRecord) -> str:
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        head = _LETTER.get(record.levelno, "I")
        parts = []
        if self.timestamps:
            parts.append(self.formatTime(record, "%H:%M:%S"))
        parts.append(f"{head} {record.name.removeprefix(ROOT + '.')}:")
        line = " ".join(parts) + " " + msg
        if self.colors:
            col = _COL.get(record.levelno, "")
            return f"{col}{line}{_RESET}" if col else line
        return line


def setup_logging(verbosity: int | None = None, colors: str | None = None,
                  logfile: str | None = None,
                  timestamps: bool | None = None, stream=None) -> logging.Logger:
    """Configure the package logger. Arguments default to the LLAMA_LOG_*
    env mirrors; colors: "auto" | "on" | "off"."""
    if verbosity is None:
        verbosity = int(os.environ.get("LLAMA_LOG_VERBOSITY", "0"))
    if colors is None:
        colors = os.environ.get("LLAMA_LOG_COLORS", "auto")
    if timestamps is None:
        timestamps = os.environ.get("LLAMA_LOG_TIMESTAMPS", "") not in ("", "0")
    if logfile is None:
        logfile = os.environ.get("LLAMA_LOG_FILE") or None

    stream = stream or sys.stderr
    use_color = (colors == "on"
                 or (colors == "auto" and getattr(stream, "isatty", lambda: False)()))

    root = logging.getLogger(ROOT)
    root.handlers.clear()
    root.propagate = False
    level = (logging.ERROR if verbosity < 0
             else logging.INFO if verbosity == 0 else logging.DEBUG)
    root.setLevel(level)

    h = logging.StreamHandler(stream)
    h.setFormatter(_Formatter(use_color, bool(timestamps)))
    root.addHandler(h)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(_Formatter(False, True))  # file sink: plain + ts
        root.addHandler(fh)
    return root


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{ROOT}.{name}" if name else ROOT)


def add_log_args(ap) -> None:
    """The reference's common log flags (common/arg.cpp)."""
    ap.add_argument("--log-file", default=None,
                    help="also write logs to this file")
    ap.add_argument("--log-colors", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--log-timestamps", action="store_true")
    ap.add_argument("-lv", "--log-verbosity", type=int, default=0,
                    help="<0 errors only, 0 info, >=1 debug")


def apply_log_args(args) -> logging.Logger:
    return setup_logging(verbosity=args.log_verbosity,
                         colors=args.log_colors, logfile=args.log_file,
                         timestamps=args.log_timestamps)
