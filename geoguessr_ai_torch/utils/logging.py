"""Metric logging to stdout (counterpart of geoguessr_ai_tpu/utils/logging.py
without its W&B and TensorBoard backends)."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Dict

logger = logging.getLogger("geoguessr_ai_torch")


def _ensure_handler() -> None:
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)


class MetricsLogger:
    """Writes metrics as one JSON object per line through the
    ``geoguessr_ai_torch`` logger."""

    def __init__(self):
        _ensure_handler()

    def log(self, metrics: Dict[str, float], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) or hasattr(v, "item")}
        logger.info(json.dumps({"step": step, **scalars}))

    def summary(self, key: str, value) -> None:
        logger.info(json.dumps({"summary": {key: value}}))


class StepTimer:
    """Rolling steps/sec over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)
