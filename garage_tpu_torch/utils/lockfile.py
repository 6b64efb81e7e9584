"""Copy of garage_tpu/utils/lockfile.py: import paths rewritten, issue and PR tags dropped.

Exclusive per-metadata-dir process lock.

Guards offline maintenance against a live server: an offline counter
recount racing a live count() would rewrite totals that then win the
CRDT merge cluster-wide with stale values (see IndexCounter.recount).
The running server holds `{metadata_dir}/garage.lock` for its
lifetime; `garage repair-offline` and `convert-db` take the same lock
and refuse to start while it is held. flock(2) locks are released by
the kernel if the holder dies, so a crash never wedges maintenance.
"""

from __future__ import annotations

import fcntl
import os


class AlreadyLocked(RuntimeError):
    pass


def acquire(meta_dir: str, role: str) -> int:
    """Take the exclusive meta-dir lock; -> fd to pass to release().
    Raises AlreadyLocked (naming the holder) if another process has it."""
    os.makedirs(meta_dir, exist_ok=True)
    path = os.path.join(meta_dir, "garage.lock")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        holder = ""
        try:
            holder = os.read(fd, 256).decode(errors="replace").strip()
        except OSError:
            pass
        os.close(fd)
        raise AlreadyLocked(
            f"metadata dir {meta_dir} is in use by "
            f"{holder or 'another process'} — stop it before running "
            f"offline maintenance") from None
    os.ftruncate(fd, 0)
    os.write(fd, f"{role} pid={os.getpid()}".encode())
    return fd


def release(fd: int) -> None:
    try:
        fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
