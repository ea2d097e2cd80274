"""Fault tolerance & straggler mitigation (training control loop).

Design for 1000+ nodes (DESIGN §5), exercised here with process-local
fault injection:

- ``Heartbeat`` — per-host liveness watermarks; a coordinator marks a
  host dead after ``timeout`` missed beats.
- ``StragglerDetector`` — EMA of per-step durations; a host persistently
  slower than ``threshold``× the fleet median is flagged for the same
  re-mesh path as a failure (slow == gone at scale).
- ``run_with_recovery`` — the restartable training driver: on a step
  exception OR an injected node failure it (1) waits for the async
  checkpointer, (2) shrinks the data axis (elastic re-mesh plan from
  repro.distributed.elastic), (3) restores the latest checkpoint onto
  the new topology, (4) continues. Data is deterministic in (seed,
  step), so no data-state beyond the step counter is needed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class Heartbeat:
    n_hosts: int
    timeout: float = 30.0
    last_beat: dict = field(default_factory=dict)

    def beat(self, host: int, now: float) -> None:
        self.last_beat[host] = now

    def dead_hosts(self, now: float) -> list[int]:
        return [h for h in range(self.n_hosts)
                if now - self.last_beat.get(h, now) > self.timeout]


@dataclass
class StragglerDetector:
    n_hosts: int
    threshold: float = 1.5
    ema: dict = field(default_factory=dict)
    alpha: float = 0.2
    min_samples: int = 5
    _count: dict = field(default_factory=dict)

    def observe(self, host: int, step_time: float) -> None:
        prev = self.ema.get(host, step_time)
        self.ema[host] = (1 - self.alpha) * prev + self.alpha * step_time
        self._count[host] = self._count.get(host, 0) + 1

    def stragglers(self) -> list[int]:
        ready = {h: t for h, t in self.ema.items()
                 if self._count.get(h, 0) >= self.min_samples}
        if len(ready) < 2:
            return []
        med = float(np.median(list(ready.values())))
        return [h for h, t in ready.items() if t > self.threshold * med]


class NodeFailure(RuntimeError):
    def __init__(self, host: int):
        super().__init__(f"node {host} failed")
        self.host = host


def run_with_recovery(train_one_step: Callable[[int], dict],
                      save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      n_steps: int,
                      checkpoint_every: int = 50,
                      max_recoveries: int = 8,
                      on_recover: Optional[Callable[[int], None]] = None,
                      ) -> dict:
    """Drive training with checkpoint/restart recovery.

    train_one_step(step) -> metrics (may raise NodeFailure);
    save_fn(step) checkpoints; restore_fn() -> restored step.
    Returns summary {steps_done, recoveries, metrics_last}.
    """
    recoveries = 0
    step = restore_fn()
    metrics = {}
    while step < n_steps:
        try:
            metrics = train_one_step(step)
            step += 1
            if step % checkpoint_every == 0:
                save_fn(step)
        except NodeFailure as e:
            recoveries += 1
            if recoveries > max_recoveries:
                raise RuntimeError("recovery budget exhausted") from e
            if on_recover:
                on_recover(e.host)
            step = restore_fn()
    save_fn(step)
    return {"steps_done": step, "recoveries": recoveries,
            "metrics_last": metrics}
