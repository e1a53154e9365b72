"""Crash diagnostics (srsran crash handler / backtrace-to-file analog).

Reference behavior: lib/src/common/crash_handler.cc — install signal
handlers that append a backtrace + build info to ./srsran.backtrace.crash
before dying.  Here: faulthandler covers hard faults (SIGSEGV/SIGFPE/...),
sys.excepthook covers uncaught Python exceptions; both append to the
crash file with a timestamp and the git build id when available.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import sys
import traceback

CRASH_FILE = "srslte_tpu.backtrace.crash"

_installed = False
_fh = None


def _build_id() -> str:
    try:
        import subprocess

        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, timeout=2,
                              cwd=os.path.dirname(__file__)).stdout.strip()
    except Exception:
        return "unknown"


def install(path: str = CRASH_FILE):
    """Install the crash handlers (idempotent)."""
    global _installed, _fh
    if _installed:
        return
    _installed = True
    _fh = open(path, "a")
    _fh.write(f"--- crash handler armed {datetime.datetime.now().isoformat()}"
              f" build={_build_id()} pid={os.getpid()} ---\n")
    _fh.flush()
    # hard faults: the OS-level backtrace writer
    faulthandler.enable(file=_fh, all_threads=True)

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        _fh.write(f"--- uncaught exception "
                  f"{datetime.datetime.now().isoformat()} ---\n")
        traceback.print_exception(exc_type, exc, tb, file=_fh)
        _fh.flush()
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook


def uninstall():
    global _installed, _fh
    if not _installed:
        return
    faulthandler.disable()
    sys.excepthook = sys.__excepthook__
    if _fh is not None:
        _fh.close()
        _fh = None
    _installed = False
