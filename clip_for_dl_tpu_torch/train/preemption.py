"""Preemption handling (copy of ``clip_for_dl_tpu.train.preemption``).

A machine that is reclaimed receives SIGTERM. ``PreemptionGuard`` installs a
handler that flips a flag; the train loop (``train/loop.py fit``) checks it
after every batch, saves a step-granular checkpoint in the preemption slot
and stops, so the next start resumes (``resume_or_init``). The module is
framework-neutral, so it is copied unchanged but for its logger's name;
``tests/test_torch_phase_b.py`` holds the copy equal by source text.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

logger = logging.getLogger("clip_for_dl_tpu_torch.preemption")


class PreemptionGuard:
    """Context manager: catch SIGTERM/SIGINT, expose `.requested`."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        logger.warning("received signal %d — checkpointing at next boundary",
                       signum)
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            self._previous[s] = signal.getsignal(s)
            try:
                signal.signal(s, self._handler)
            except ValueError:
                # not the main thread — polling-only mode
                pass
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        return False

    def trigger(self) -> None:
        """Manual trigger (tests / external orchestration)."""
        self._event.set()
