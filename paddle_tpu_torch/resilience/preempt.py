"""paddle_tpu_torch.resilience.preempt — preemption as a process
lifecycle event.

Counterpart of ``paddle_tpu/resilience/preempt.py``. A scheduler
preempts with SIGTERM and the process has seconds to act. The handler
turns that signal into a cooperative flag (:attr:`PreemptionHandler.
triggered`) that a loop polls at its boundaries, flushes any attached
save callbacks (``attach(save_fn=)``, given the last completed step from
:meth:`~PreemptionHandler.notify_step`) on a real signal, and chains the
handler it replaced.

Signal handlers are process-global and main-thread-only; installing
from a worker thread is a silent no-op (the flag can still be set by
:meth:`~PreemptionHandler.request`, which is how simulated preemption
and tests drive it). Handlers may be uninstalled in any order: one
buried beneath later installs is spliced out of the chain instead of
clobbering a later handler's registration.

:func:`subscribe` registers a process-level listener that every
:class:`PreemptionHandler` broadcasts to on its first trigger (real
signal or simulated). The serving fleets subscribe here: on SIGTERM a
``MultiDeviceEngine`` flips every replica to draining and finishes its
work instead of dying mid-stream. Every notice counts
``resilience.preempt.notice`` on the port's monitor.

Not ported: the training loops' save-and-stop at a step boundary
(``hapi.Model.fit``, ``Executor.train_from_dataset``; ROADMAP.md Queue A
item 18), which poll this handler.
"""
from __future__ import annotations

import signal
import threading
import warnings

from ._common import record

# -- process-level lifecycle broadcast --------------------------------------

_sub_lock = threading.Lock()
_subscribers = []

#: handlers in install order — uninstalling out of LIFO order splices
#: the chain instead of clobbering a later handler's registration
_install_stack = []


def subscribe(callback):
    """Register a process-level preemption listener: ``callback(signum)``
    runs on the FIRST trigger of any :class:`PreemptionHandler` (real
    signal or simulated :meth:`~PreemptionHandler.request`). Returns the
    callback, which doubles as the :func:`unsubscribe` handle. Callbacks
    must be fast and must not raise — failures are warned and
    swallowed; the signal path must never die notifying."""
    with _sub_lock:
        _subscribers.append(callback)
    return callback


def unsubscribe(callback):
    """Remove a listener registered with :func:`subscribe` (idempotent)."""
    with _sub_lock:
        try:
            _subscribers.remove(callback)
        except ValueError:
            pass


def notify(signum=None):
    """Broadcast one preemption notice to every subscriber and count it
    (``resilience.preempt.notice``). Handlers call this on their first
    trigger; tests and simulated preemption may call it directly."""
    record("preempt.notice", signum=signum)
    with _sub_lock:
        subs = list(_subscribers)
    for cb in subs:
        try:
            cb(signum)
        except Exception as e:   # noqa: BLE001 - never die notifying
            warnings.warn(
                f"preempt subscriber {cb!r} failed: {e!r}")


class PreemptionHandler:
    """Install with ``with PreemptionHandler() as p:`` (or
    ``install()``/``uninstall()``); poll ``p.triggered`` at step
    boundaries. Previous handlers are chained — an outer framework's
    SIGTERM logic still runs — and restored on uninstall."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 on_preempt=None):
        self.signals = tuple(signals)
        self.on_preempt = on_preempt
        self._event = threading.Event()
        self._previous = {}
        self._installed = False
        self._save_fns = []
        self._ckpt = None
        self._last_step = None
        self.flushed_step = None  # set when request() flushed a save

    def attach(self, checkpoint_manager=None, save_fn=None):
        """Arm the final-save flush: on a real signal, :meth:`request`
        calls each attached ``save_fn(step)`` (default:
        ``checkpoint_manager.save(step)``) with the last step reported
        via :meth:`notify_step`. Train loops attach a save_fn that
        captures their model/optimizer. Repeated calls *accumulate*
        callbacks — several subsystems can each arm their own flush;
        they run in attach order."""
        if checkpoint_manager is not None:
            self._ckpt = checkpoint_manager
        fn = save_fn if save_fn is not None else (
            checkpoint_manager.save if checkpoint_manager is not None
            else None)
        if fn is not None and fn not in self._save_fns:
            self._save_fns.append(fn)
        return self

    def detach(self, save_fn=None):
        """Drop one attached callback (or all, when ``save_fn=None``)."""
        if save_fn is None:
            self._save_fns.clear()
            self._ckpt = None
        else:
            try:
                self._save_fns.remove(save_fn)
            except ValueError:
                pass
        return self

    def notify_step(self, step):
        """Record the last *completed* step — what a flush would save."""
        self._last_step = step

    @property
    def triggered(self):
        return self._event.is_set()

    def _flush_save(self, signum):
        if not self._save_fns or self._last_step is None:
            return
        step = self._last_step
        any_ok = False
        for fn in list(self._save_fns):
            try:
                fn(step)
                any_ok = True
            except Exception as e:  # the signal path must never die saving
                warnings.warn(
                    f"PreemptionHandler: final save at step {step} failed "
                    f"({e!r}); relying on the last periodic checkpoint")
        if not any_ok:
            return
        self.flushed_step = step
        record("preempt_save", step=step, where="signal_flush",
               signum=signum)

    def request(self, signum=None):
        """Mark preemption requested (the signal handler body; also the
        entry point for simulated preemption)."""
        first = not self._event.is_set()
        self._event.set()
        if first:
            record("preempt_signal", signum=signum)
            if signum is not None:
                self._flush_save(signum)
            if self.on_preempt is not None:
                self.on_preempt(signum)
            notify(signum)

    def _handle(self, signum, frame):
        self.request(signum)
        prev = self._previous.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL,
                                           signal.default_int_handler):
            prev(signum, frame)

    def install(self):
        if self._installed:
            return self
        try:
            for s in self.signals:
                self._previous[s] = signal.signal(s, self._handle)
            self._installed = True
            _install_stack.append(self)
        except ValueError:
            # not the main thread: signals can't be installed here; the
            # cooperative flag still works via request()
            self._previous.clear()
        return self

    def uninstall(self):
        """Remove this handler; safe in any order. The most recently
        installed handler restores the OS registration it replaced
        (LIFO); a handler buried beneath later installs is *spliced out*
        instead — the nearest handler above it that chains to this one
        is repointed at this handler's predecessor, so no later
        handler's registration is clobbered."""
        if not self._installed:
            return
        try:
            idx = _install_stack.index(self)
        except ValueError:
            idx = -1
        above = _install_stack[idx + 1:] if idx >= 0 else []
        for s, prev in self._previous.items():
            spliced = False
            for h in above:
                if h._previous.get(s) == self._handle:
                    h._previous[s] = prev
                    spliced = True
                    break
            if not spliced:
                try:
                    if signal.getsignal(s) == self._handle:
                        signal.signal(s, prev)
                except ValueError:
                    pass
        if idx >= 0:
            _install_stack.pop(idx)
        self._previous.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
