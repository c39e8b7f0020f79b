"""Meters and a phase timer (cocodet_tpu/utils/metric.py:19-107:
``AverageMeter``, ``MeterBuffer``, ``Timer``)."""

from __future__ import annotations

import functools
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    """Windowed running average."""

    def __init__(self, window_size: int = 50):
        self._window = deque(maxlen=window_size)
        self._total = 0.0
        self._count = 0

    def update(self, value):
        value = float(value)
        self._window.append(value)
        self._total += value
        self._count += 1

    @property
    def median(self) -> float:
        return float(np.median(self._window)) if self._window else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self._window)) if self._window else 0.0

    @property
    def global_avg(self) -> float:
        return self._total / max(self._count, 1)

    @property
    def total(self) -> float:
        return self._total

    @property
    def latest(self) -> float:
        return self._window[-1] if self._window else 0.0

    def reset(self):
        self._window.clear()
        self._total = 0.0
        self._count = 0

    def clear(self):
        self._window.clear()


class MeterBuffer(defaultdict):
    """Dict of AverageMeters with key filtering."""

    def __init__(self, window_size: int = 20):
        super().__init__(functools.partial(AverageMeter, window_size))

    def update(self, values: Optional[Dict] = None, **kwargs):
        values = dict(values or {}, **kwargs)
        for k, v in values.items():
            self[k].update(v)

    def get_filtered_meter(self, filter_key: str = "time") -> Dict[str, AverageMeter]:
        return {k: v for k, v in self.items() if filter_key in k}

    def reset_filtered(self, filter_key: str):
        for v in self.get_filtered_meter(filter_key).values():
            v.reset()

    def clear_meters(self):
        for v in self.values():
            v.clear()


class Timer:
    """Phase timer; call ``tic``/``toc(name)`` around host-blocking points."""

    def __init__(self):
        self._t = time.perf_counter()
        self.meters = MeterBuffer()

    def tic(self):
        self._t = time.perf_counter()

    def toc(self, name: str) -> float:
        dt = time.perf_counter() - self._t
        self.meters.update({name: dt})
        self._t = time.perf_counter()
        return dt
