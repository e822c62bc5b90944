"""Metric logging to stdout (counterpart of geoguessr_ai_tpu/utils/logging.py
without its W&B and TensorBoard backends)."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Dict, Optional

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
    ``geoguessr_ai_torch`` logger, and the run's ``project`` and
    ``run_config`` once at the start (the JAX package also sends them to
    W&B and TensorBoard, which the port leaves out)."""

    def __init__(self, project: str = "geoguessr-tpu",
                 run_config: Optional[dict] = None):
        _ensure_handler()
        if run_config is not None:
            logger.info(json.dumps({"run": project, "config": run_config},
                                   default=str))

    def log(self, metrics: Dict[str, float], step: int) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float)) or hasattr(v, "item")}
        logger.info(json.dumps({"step": step, **scalars}))

    def summary(self, key: str, value) -> None:
        logger.info(json.dumps({"summary": {key: value}}))

    def finish(self) -> None:
        """Ends the run (the JAX package closes its W&B run and TensorBoard
        writer here; stdout needs nothing)."""


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
