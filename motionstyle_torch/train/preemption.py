"""Graceful preemption for the trainers (counterpart of
motionstyle/train/preemption.py): on SIGTERM/SIGINT the step in flight
finishes, a checkpoint is written at the step boundary, and `preempted`
turns True so the caller's loop exits; resume continues from that step."""
from __future__ import annotations

import signal

from motionstyle_torch.train import logging as logger


class PreemptionMixin:
    """Adds install_preemption_handler()/restore_signal_handlers(); the
    training loop checks `self.preempted` at each step boundary."""

    preempted = False

    def install_preemption_handler(self, signals=None):
        self.preempted = False
        self._old_handlers = {}

        def _handler(signum, frame):
            logger.log(f"signal {signum}: checkpointing at next step boundary")
            self.preempted = True

        for s in signals or (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[s] = signal.signal(s, _handler)

    def restore_signal_handlers(self):
        for s, h in getattr(self, "_old_handlers", {}).items():
            signal.signal(s, h)
        self._old_handlers = {}
