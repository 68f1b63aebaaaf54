"""The non-finite loss sentinel of the train loop.

An own copy of ``NonFiniteLossError``/``NonFiniteSentinel`` from
``mmlspark_tpu/obs/anomaly.py``, without the tracer: the check is a
``math.isfinite`` on a loss value the loop has already fetched, so it
costs no device sync. Modes: ``raise`` (the default) dies at the
divergence with a typed error, ``event`` logs it and continues, ``off``
skips the check.
"""

from __future__ import annotations

import math

from mmlspark_tpu_torch.core.logging_utils import get_logger

_log = get_logger(__name__)

NONFINITE_MODES = ("raise", "event", "off")


class NonFiniteLossError(RuntimeError):
    """The training loss went NaN/Inf; carries the step and the value."""

    def __init__(self, loop: str, step: int, value: float):
        self.loop = loop
        self.step = step
        self.value = value
        super().__init__(
            f"{loop}: loss became non-finite ({value}) at global step "
            f"{step}; the run has diverged (bad learning rate, bad batch, "
            "or numerical overflow). Set TrainConfig.nonfinite_loss="
            "'event' to record and continue instead")


class NonFiniteSentinel:
    """Check each (lagged) fetched loss; fire once per bad step."""

    __slots__ = ("loop", "mode", "fired", "_last_step")

    def __init__(self, loop: str, mode: str = "raise"):
        if mode not in NONFINITE_MODES:
            raise ValueError(
                f"nonfinite_loss must be one of {NONFINITE_MODES}: "
                f"{mode!r}")
        self.loop = loop
        self.mode = mode
        self.fired = 0
        self._last_step: int | None = None

    def check(self, step: int, value: float) -> float:
        """Validate one fetched loss; returns it as a float. One log line
        or raise per offending step, even if its value is checked twice."""
        value = float(value)
        if self.mode == "off" or math.isfinite(value):
            return value
        if step == self._last_step:
            return value
        self._last_step = step
        self.fired += 1
        if self.mode == "raise":
            raise NonFiniteLossError(self.loop, int(step), value)
        _log.warning("%s: non-finite loss %s at global step %d", self.loop,
                     value, step)
        return value
