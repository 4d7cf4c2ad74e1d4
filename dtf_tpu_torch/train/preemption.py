"""Preemption-aware graceful shutdown -- a copy of
``dtf_tpu/train/preemption.py`` (the port imports nothing of dtf_tpu).

On preemptible machines SIGTERM is the preemption signal: the scheduler
gives a rank a short grace window before the hard kill.  The reference's story
was "Workers will need to restart training" (SURVEY §5.4) — work since
the last per-epoch checkpoint was simply lost.  Here SIGTERM/SIGINT is
caught, the train loop finishes the in-flight step, writes an
EMERGENCY checkpoint at the next step boundary (synchronous: the save
is durable and its integrity manifest committed before the process
exits), and the process exits with the
distinct ``EXIT_PREEMPTED`` code the launch.py supervisor classifies as
"preempted": restart WITHOUT consuming the crash-restart budget.

The handler is cooperative, not preemptive: it only sets a flag; the
loop polls it at step boundaries (``triggered()``), so device state is
never torn mid-step.  A second SIGINT restores the default handler —
an operator mashing Ctrl-C still gets the hard kill.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

# 75: the code cli/launch.py restarts without spending the crash budget
from dtf_tpu_torch.chaos import EXIT_PREEMPTED  # noqa: F401

log = logging.getLogger("dtf_tpu_torch")

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class Preempted(Exception):
    """Raised by the train loop at the step boundary after a
    preemption signal, once the emergency checkpoint is durable.
    Callers (cli/runner) translate it into SystemExit(EXIT_PREEMPTED)."""

    def __init__(self, step: int, signum: int):
        self.step = int(step)
        self.signum = int(signum)
        super().__init__(
            f"preempted by signal {signum} at step {step} "
            f"(emergency checkpoint written)")


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that latch the signal number.

    Only the main thread can install signal handlers; off-main-thread
    construction (tests driving run() from a worker) degrades to a
    guard that never triggers — the process keeps its default signal
    behavior."""

    def __init__(self):
        self._signum: Optional[int] = None
        self._old = {}
        self.active = False
        try:
            for sig in _SIGNALS:
                self._old[sig] = signal.signal(sig, self._handle)
            self.active = True
        except ValueError:  # not the main thread
            self._old = {}
            log.warning("preemption guard: not the main thread — "
                        "SIGTERM will NOT trigger a graceful checkpoint")

    def _handle(self, signum, frame):
        if self._signum is not None and signum == signal.SIGINT:
            # second Ctrl-C: the operator wants out NOW
            self.restore()
            raise KeyboardInterrupt
        first = self._signum is None
        self._signum = signum
        if first:
            log.warning("received signal %d — will write an emergency "
                        "checkpoint at the next step boundary and exit "
                        "%d (preempted)", signum, EXIT_PREEMPTED)

    def latch(self, signum: int = signal.SIGTERM) -> None:
        """Latch a preemption WITHOUT a delivered signal — the metadata
        poller's entry point (a pending GCE preemption is visible on
        the metadata server before the SIGTERM lands).  Same downstream
        path: the loop sees triggered() at the next step boundary."""
        self._handle(int(signum), None)

    @property
    def triggered(self) -> Optional[int]:
        return self._signum

    def restore(self) -> None:
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._old = {}
        self.active = False


_guard: Optional[PreemptionGuard] = None
_lock = threading.Lock()


def install() -> PreemptionGuard:
    """Install (or return) the process-global guard."""
    global _guard
    with _lock:
        if _guard is None or not _guard.active:
            _guard = PreemptionGuard()
        return _guard


def restore() -> None:
    """Uninstall the global guard and restore prior signal handlers."""
    global _guard
    with _lock:
        if _guard is not None:
            _guard.restore()
        _guard = None


def triggered() -> Optional[int]:
    """The latched preemption signal number, or None.  Fast: one global
    read — safe to poll every step."""
    g = _guard
    if g is None:
        return None
    return g.triggered


def latch(signum: int = signal.SIGTERM) -> None:
    """Latch a preemption on the global guard (no-op when none is
    installed — a bare poller without install() has nothing to feed)."""
    g = _guard
    if g is not None:
        g.latch(signum)


# GCE/TPU-VM metadata preemption endpoint: returns the string "TRUE"
# once the instance has a pending/acting preemption.  DTF_METADATA_URL
# overrides (tests run a local fake; other clouds have equivalents).
DEFAULT_METADATA_URL = ("http://metadata.google.internal/computeMetadata"
                        "/v1/instance/preempted")


class MetadataPoller:
    """Daemon-thread poll of the cloud metadata preemption endpoint.

    Most schedulers deliver SIGTERM directly and the PreemptionGuard
    handles it; this poller covers the window where the preemption is
    only visible on the metadata server (and hosts where the signal is
    swallowed by a wrapper).  On "TRUE" it feeds the SAME latch, so the
    downstream path — emergency checkpoint at the step boundary, exit
    EXIT_PREEMPTED, unbudgeted supervisor restart — is identical and
    stays test-pinned once.

    Off by default (--preemption_poll_s 0).  An unreachable endpoint
    (not on GCE) logs once at INFO and keeps polling quietly — the
    poller must be safe to leave enabled in any environment."""

    def __init__(self, poll_s: float, url: Optional[str] = None):
        import os
        if poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {poll_s}")
        self.poll_s = float(poll_s)
        self.url = (url or os.environ.get("DTF_METADATA_URL")
                    or DEFAULT_METADATA_URL)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unreachable_logged = False
        self.preempted = False

    def poll_once(self) -> bool:
        """One metadata query; True when a preemption is pending.
        Network errors are 'not preempted' (logged once)."""
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(
                    req, timeout=max(self.poll_s, 1.0)) as resp:
                body = resp.read(64).decode("utf-8", "replace")
            return body.strip().upper() == "TRUE"
        except (urllib.error.URLError, OSError, ValueError):
            if not self._unreachable_logged:
                self._unreachable_logged = True
                log.info("preemption poller: metadata endpoint %s "
                         "unreachable — polling continues quietly "
                         "(expected off-GCE)", self.url)
            return False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self.poll_once():
                self.preempted = True
                log.warning("preemption poller: metadata server reports "
                            "a pending preemption — latching SIGTERM "
                            "(emergency checkpoint at the next step "
                            "boundary)")
                latch(signal.SIGTERM)
                return

    def start(self) -> "MetadataPoller":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dtf-preempt-poll")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 2.0)
            self._thread = None
