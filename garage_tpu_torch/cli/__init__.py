"""Copy of garage_tpu/cli/__init__.py: import paths rewritten, issue and PR tags dropped.

CLI entry points (server, operator CLI, k2v-cli)."""

from __future__ import annotations


def reset_sigpipe() -> None:
    """Default SIGPIPE so `| head`/`| grep -q` closing the pipe kills
    the process quietly instead of raising BrokenPipeError (standard
    unix CLI behavior)."""
    import signal

    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass  # no SIGPIPE on this platform / not main thread
