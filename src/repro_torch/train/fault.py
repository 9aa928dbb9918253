"""Fault tolerance & straggler mitigation for the training loop.

At 1000+ nodes the failure model is: (a) hard node loss → job restarts
(possibly on fewer pods) and restores the latest checkpoint, resharding
elastically; (b) stragglers → detected by step-time anomaly tracking;
the scheduler-level remedies (hot spares, re-slicing) are cluster-side,
but the *detection* signal and the in-job policy hooks live here.

``run_resilient`` wraps the step loop: simulated/real exceptions trigger
restore-and-continue, bounded by ``max_restarts``. The same hook is
where a real deployment calls its cluster manager.

A copy of ``src/repro/train/fault.py``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than k× the mean."""
    alpha: float = 0.1
    threshold: float = 2.5
    ewma: Optional[float] = None
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        is_straggler = (self.ewma is not None
                        and seconds > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append(step)
        self.ewma = (seconds if self.ewma is None
                     else (1 - self.alpha) * self.ewma + self.alpha * seconds)
        return is_straggler


@dataclass
class FaultPolicy:
    max_restarts: int = 3
    on_straggler: str = "log"       # 'log' | 'skip-sync' (doc'd; cluster-side)
    checkpoint_every: int = 50


class Preemption(Exception):
    """Raised (or injected in tests) to simulate node loss."""


def run_resilient(step_fn: Callable[[int], Dict], start_step: int,
                  total_steps: int, restore_fn: Callable[[], int],
                  save_fn: Callable[[int], None],
                  policy: Optional[FaultPolicy] = None,
                  monitor: Optional[StragglerMonitor] = None,
                  log_fn: Callable[[str], None] = print) -> Dict:
    """Run step_fn(step) for steps [start, total); on failure restore the
    latest checkpoint and continue. Returns summary stats."""
    policy = policy or FaultPolicy()
    monitor = monitor or StragglerMonitor()
    restarts = 0
    step = start_step
    metrics: Dict = {}
    while step < total_steps:
        try:
            t0 = time.time()
            metrics = step_fn(step)
            dt = time.time() - t0
            if monitor.observe(step, dt):
                log_fn(f"[fault] straggler suspected at step {step} "
                       f"({dt:.2f}s vs ewma {monitor.ewma:.2f}s) — policy="
                       f"{policy.on_straggler}")
            if (step + 1) % policy.checkpoint_every == 0:
                save_fn(step + 1)
            step += 1
        except Preemption as e:
            restarts += 1
            if restarts > policy.max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={policy.max_restarts}") from e
            log_fn(f"[fault] preemption at step {step}: {e}; restoring")
            step = restore_fn()
    return {"final_step": step, "restarts": restarts,
            "stragglers": list(monitor.flagged), "last_metrics": metrics}
