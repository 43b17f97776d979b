"""File locking.

Jax-free copy of ``elektronn2_tpu/utils/locking.py`` (reference:
``elektronn2/utils/locking.py::FileLock``, vendored) — guards
concurrent KNOSSOS cube-cache writes and model save files. POSIX
implementation on fcntl with timeout + stale-lock detection.
"""

from __future__ import annotations

import errno
import os
import socket
import time

from ..log import logger


class FileLockException(Exception):
    pass


class FileLock:
    """Advisory lock via an exclusive ``<file>.lock`` sentinel.

    Usage:
        with FileLock("model.mdl", timeout=10):
            ...write...
    """

    def __init__(self, protected_file_path, timeout=10.0, delay=0.05,
                 lock_file_contents=None):
        self.lockfile = protected_file_path + ".lock"
        self.timeout = float(timeout)
        self.delay = float(delay)
        # the token makes the contents unique per FileLock instance, so
        # ownership can be verified at release even across pid reuse
        self._contents = (lock_file_contents or
                          f"pid={os.getpid()} host={socket.gethostname()} "
                          f"token={time.monotonic_ns():x}.{id(self):x}")
        self.is_locked = False

    def _break_if_stale(self):
        """Atomically claim a lock whose recorded owner pid is dead
        (crashed/killed holder never ran release — exactly the
        crash-recovery scenario in which the trainer auto-resumes and must
        be able to save again).

        Two safety rules (multi-host shared storage, TOCTOU):
        - pid liveness is only meaningful on the host that wrote the lock;
          if the recorded hostname differs from ours, never break it
          (``jax.distributed`` multi-host runs share the save directory).
        - breaking is an atomic ``os.rename`` of the lockfile to a unique
          temp name: of N contenders that all saw the same dead pid, only
          the rename winner removes it, so a freshly re-created lock can
          never be unlinked by a loser still acting on stale information.
        """
        try:
            with open(self.lockfile) as f:
                contents = f.read()
        except OSError:
            return False        # raced with the owner's release
        if "pid=" not in contents:
            return False        # foreign lock format: leave it alone
        try:
            pid = int(contents.split("pid=")[1].split()[0])
        except (ValueError, IndexError):
            return False
        if "host=" in contents:
            host = contents.split("host=")[1].split()[0]
            if host != socket.gethostname():
                return False    # remote holder: cannot test liveness
        if pid == os.getpid():
            return False
        try:
            os.kill(pid, 0)     # signal 0: existence check only
            return False        # owner alive
        except ProcessLookupError:
            pass                # owner dead → stale
        except PermissionError:
            return False        # alive, other user
        grave = f"{self.lockfile}.stale.{os.getpid()}.{time.monotonic_ns()}"
        try:
            os.rename(self.lockfile, grave)   # atomic: one winner only
        except OSError:
            return True         # someone else broke it first — retry open
        # Verify the corpse is the lock we diagnosed, not a fresh lock that
        # replaced it between read and rename (rename would have claimed the
        # new owner's lock); if so, reinstate it with os.link — which,
        # unlike os.rename, FAILS if a lockfile already exists again, so a
        # third contender's freshly created lock is never clobbered (a
        # rename-back reinstate would itself be a TOCTOU).
        try:
            with open(grave) as f:
                if f.read() != contents:
                    try:
                        os.link(grave, self.lockfile)   # no-clobber restore
                    except OSError as e:
                        if e.errno == errno.EEXIST:
                            # a new lock appeared in the window — the
                            # displaced holder cannot be restored without
                            # clobbering it; drop the corpse and surface
                            # the (vanishingly rare: needs break+reacquire
                            # +acquire within one read-rename window)
                            # incident in the log
                            logger.warning(
                                f"FileLock: displaced a live lock at "
                                f"{self.lockfile} and could not restore "
                                f"it (a newer lock exists); holders "
                                f"should verify ownership at release")
                        else:
                            # filesystem without hard links (CIFS/FAT/
                            # some NFS): fall back to the rename restore
                            # — clobber-prone only in the triple-contender
                            # window, vs destroying the displaced live
                            # lock outright
                            os.rename(grave, self.lockfile)
                            return False
                    os.unlink(grave)
                    return False
            os.unlink(grave)
        except OSError:
            pass
        return True

    def acquire(self):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                fd = os.open(self.lockfile,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, self._contents.encode())
                os.close(fd)
                self.is_locked = True
                return self
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise
                if self._break_if_stale():
                    continue
                if time.monotonic() > deadline:
                    raise FileLockException(
                        f"could not acquire {self.lockfile} within "
                        f"{self.timeout}s") from None
                time.sleep(self.delay)

    def release(self):
        if self.is_locked:
            # verify ownership before unlinking: if a (mis)breaker
            # displaced this lock and someone else re-acquired, the file
            # on disk is no longer ours and must stay. Only a MISSING
            # file is swallowed — other failures (EACCES, read-only
            # remount) propagate so the operator sees why the lock could
            # not be cleaned up (a blanket pass would leave orphaned
            # locks with no log trail)
            self.is_locked = False
            try:
                with open(self.lockfile) as f:
                    mine = f.read() == self._contents
            except FileNotFoundError:
                return
            if mine:
                try:
                    os.unlink(self.lockfile)
                except FileNotFoundError:
                    pass
            else:
                logger.warning(
                    f"FileLock: {self.lockfile} is no longer held by "
                    f"this process at release (broken as stale?) — "
                    f"leaving the current holder's lock in place")

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __del__(self):
        self.release()
