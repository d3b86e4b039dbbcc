"""Scheduler: periodic in-run callbacks (the port's own copy of
`somar_tpu.utils.scheduler`, pure Python): register (fn, step interval,
time period); the driver fires them after each step by step count or
simulation-time period.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List


@dataclasses.dataclass
class _Task:
    fn: Callable            # fn(step, time, state) -> None
    step_interval: int = 0  # fire every N steps (0 = off)
    time_period: float = 0.0  # fire every T sim time (0 = off)
    last_fired_time: float = -1.0e300


class Scheduler:
    def __init__(self):
        self._tasks: List[_Task] = []

    def schedule(self, fn: Callable, step_interval: int = 0,
                 time_period: float = 0.0):
        self._tasks.append(_Task(fn, step_interval, time_period))

    def execute(self, step: int, time: float, state=None):
        for t in self._tasks:
            fire = False
            if t.step_interval > 0 and step % t.step_interval == 0:
                fire = True
            if t.time_period > 0.0 and \
                    time - t.last_fired_time >= t.time_period:
                fire = True
            if fire:
                t.last_fired_time = time
                t.fn(step, time, state)
