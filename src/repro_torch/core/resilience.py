"""Pipeline-wide failure model: fault injection, deadlines, degradation.

Scheduling-as-a-service means a schedule request must *never* crash the
caller: a corrupt cache file, a gcc OOM, a subprocess timeout or an ILP
blowup has to degrade the answer, not abort the process.  This module is
the shared vocabulary for that:

* **Fault-injection registry** — named sites (:data:`FAULT_SITES`)
  threaded through the scheduling stack.  Production code calls
  :func:`fault_point` at each site (a no-op when nothing is armed);
  tests arm sites with seeded failures or delays via
  :meth:`FaultRegistry.arm` / :func:`inject`.

* **Wall-clock deadlines** — a :class:`Deadline` is threaded through
  the scheduler's dimension loop and the autotuner's candidate loop and
  checked at band/SCC/candidate boundaries; a breach raises
  :class:`DeadlineExceeded`, which the degradation ladder turns into
  the best answer computable in the time that was granted.

* **Degradation ladder** — :func:`schedule_with_ladder` steps down
  deterministically on any fault or deadline breach:

  ====  ==============  =====================================================
  rung  name            result
  ====  ==============  =====================================================
  0     full            the configured schedule (possibly a warm cache hit)
  1     partial         the legal schedule prefix already solved (per-dim
                        ILPs are per-SCC decomposed, so this keeps every
                        SCC result completed before the fault) completed
                        with the program-order suffix
  2     pluto_default   a fresh pluto-style schedule, no custom config
  3     identity        the program-order identity schedule — always legal,
                        needs no solver at all
  ====  ==============  =====================================================

  Provenance (``degraded``, ``fallback_level``, ``degrade_reasons``)
  is recorded on the returned ``Schedule`` and surfaced through
  ``schedcache`` payloads and ``akg`` kernel plans.

* **Typed errors** — :class:`MeasurementError` carries the kind / tag /
  phase of a failed compile-and-measure attempt so the autotuner can
  record, retry once and exclude instead of aborting the search;
  :class:`InjectedFault` marks registry-injected failures.

Everything here is deterministic: armed faults fire on exact call
counts (or on a seeded per-arm RNG when armed probabilistically), so
the same seed + the same faults always walks the same ladder rungs and
produces bit-identical schedules.
"""
from __future__ import annotations

import random
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

#: every named fault site threaded through the pipeline.  Arming an
#: unknown site is an error — a typo must not silently never fire.
FAULT_SITES = (
    "ilp.solve",        # per-dimension lexmin (scheduler, both pipelines)
    "farkas.project",   # Farkas multiplier elimination (farkas.py)
    "fm.bounds",        # Fourier–Motzkin bound chains (polyhedron.bounds_of)
    "cache.read",       # schedcache pickle / crunner result-cache reads
    "cache.write",      # schedcache pickle / crunner / measurements writes
    "cc.compile",       # gcc invocation (crunner)
    "cc.run",           # compiled-binary execution (crunner)
    "measure",          # the measurement policy entry (crunner)
    "pool.dispatch",    # schedd worker-pool job dispatch (launch/schedd)
)

#: the four-rung degradation ladder, best → worst
LADDER = ("full", "partial", "pluto_default", "identity")


class ResilienceError(RuntimeError):
    """Base of every typed error this module raises."""


class InjectedFault(ResilienceError):
    """A failure injected by the fault registry (never raised in
    production — only when a test / chaos harness armed the site)."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


class DeadlineExceeded(ResilienceError):
    """A wall-clock deadline was breached at a checkpoint."""

    def __init__(self, stage: str, budget_s: float, elapsed_s: float):
        super().__init__(
            f"deadline exceeded at {stage!r}: "
            f"{elapsed_s:.3f}s elapsed > {budget_s:.3f}s budget")
        self.stage = stage
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s


class MeasurementError(ResilienceError):
    """A compile-and-measure attempt failed in a *known* way.

    ``kind`` is one of: ``source_blowup`` | ``compile_timeout`` |
    ``compile_failed`` | ``run_timeout`` | ``run_failed`` | ``parse`` |
    ``checksum_mismatch`` | ``injected``.  ``tag`` is the crunner build
    tag (candidate label), ``phase`` the pipeline phase that died
    (``codegen``/``compile``/``run``/``parse``/``measure``).
    """

    def __init__(self, kind: str, tag: str = "", phase: str = "",
                 detail: str = ""):
        super().__init__(
            f"measurement failed [{kind}] tag={tag or '?'} "
            f"phase={phase or '?'}" + (f": {detail}" if detail else ""))
        self.kind = kind
        self.tag = tag
        self.phase = phase
        self.detail = detail

    def row(self) -> Dict[str, str]:
        """Plain-dict rendering for failure logs / result provenance."""
        return {"kind": self.kind, "tag": self.tag, "phase": self.phase,
                "detail": self.detail[:200]}


# ---------------------------------------------------------------------------
# fault-injection registry
# ---------------------------------------------------------------------------


@dataclass
class _Arm:
    site: str
    error: Optional[Callable[[], BaseException]]  # None → delay-only arm
    times: int                  # remaining firings (<0 → unlimited)
    delay_s: float
    p: float
    rng: Optional[random.Random]
    skip: int = 0               # let this many calls pass before firing

    def should_fire(self) -> bool:
        if self.times == 0:
            return False
        if self.skip > 0:
            self.skip -= 1
            return False
        if self.rng is not None and self.rng.random() >= self.p:
            return False
        return True


class FaultRegistry:
    """Named fault sites a test / chaos harness can arm.

    Disarmed sites cost one dict lookup per :func:`fault_point` call —
    the registry is always live, there is no build flag.  ``fired``
    counts every firing per site, so a harness can assert that an armed
    site actually executed (a fault that never fires is a sweep bug,
    not a pass).
    """

    def __init__(self):
        self._arms: Dict[str, _Arm] = {}
        self.fired: Dict[str, int] = {}

    def arm(self, site: str, *, error: Any = InjectedFault,
            times: int = 1, delay_s: float = 0.0, p: float = 1.0,
            seed: int = 0, skip: int = 0) -> None:
        """Arm ``site`` to fail/delay on its next ``times`` firings.

        ``error`` may be an exception class (instantiated per firing),
        an exception instance factory, a ready instance, or ``None``
        for a delay-only arm.  ``p`` < 1 makes firings probabilistic on
        a per-arm ``random.Random(seed)`` — deterministic for a fixed
        seed and call sequence.  ``skip`` lets that many calls pass
        cleanly before the arm starts firing — the knob for injecting a
        fault *mid*-pipeline (e.g. after the first scheduling dimension
        completed, to exercise the partial-prefix ladder rung).
        """
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"known: {', '.join(FAULT_SITES)}")
        factory: Optional[Callable[[], BaseException]]
        if error is None:
            factory = None
        elif isinstance(error, BaseException):
            factory = lambda error=error: error
        elif isinstance(error, type) and issubclass(error, BaseException):
            if issubclass(error, InjectedFault):
                factory = lambda site=site: error(site)
            else:
                factory = lambda site=site: error(f"injected fault at {site}")
        elif callable(error):
            factory = error
        else:
            raise TypeError(f"unusable error spec for {site!r}: {error!r}")
        rng = random.Random(seed) if p < 1.0 else None
        self._arms[site] = _Arm(site, factory, times, delay_s, p, rng,
                                skip=skip)

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site, or every site when ``site`` is None."""
        if site is None:
            self._arms.clear()
        else:
            self._arms.pop(site, None)

    def reset(self) -> None:
        """Disarm everything and zero the firing counters."""
        self._arms.clear()
        self.fired.clear()

    def armed(self, site: str) -> bool:
        arm = self._arms.get(site)
        return arm is not None and arm.times != 0

    def fire(self, site: str) -> None:
        """Called by production code at a fault site.  No-op unless the
        site is armed; otherwise sleeps/raises per the arm."""
        arm = self._arms.get(site)
        if arm is None or not arm.should_fire():
            return
        if arm.times > 0:
            arm.times -= 1
        self.fired[site] = self.fired.get(site, 0) + 1
        if arm.delay_s > 0:
            time.sleep(arm.delay_s)
        if arm.error is not None:
            raise arm.error()


#: the process-wide registry every fault site fires through
REGISTRY = FaultRegistry()


def fault_point(site: str) -> None:
    """Production-side hook: fire ``site`` on the global registry."""
    REGISTRY.fire(site)


@contextmanager
def inject(site: str, **kw):
    """Arm ``site`` for the duration of a ``with`` block (test helper)."""
    REGISTRY.arm(site, **kw)
    try:
        yield REGISTRY
    finally:
        REGISTRY.disarm(site)


# ---------------------------------------------------------------------------
# wall-clock deadlines
# ---------------------------------------------------------------------------


class Deadline:
    """A wall-clock budget checked at pipeline boundaries.

    ``Deadline(None)`` never expires (the default everywhere, so the
    hot path pays a ``None`` check only).  Deadlines are *shared* down
    the pipeline: the scheduler, tree build and autotuner all check the
    same object, so the budget covers the request end to end, not each
    stage separately.
    """

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = budget_s
        self._clock = clock
        self._t0 = clock()

    @classmethod
    def after(cls, budget_s: Optional[float]) -> "Deadline":
        return cls(budget_s)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        return self.budget_s is not None and self.elapsed() > self.budget_s

    def check(self, stage: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent."""
        if self.budget_s is None:
            return
        el = self.elapsed()
        if el > self.budget_s:
            raise DeadlineExceeded(stage, self.budget_s, el)


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------


def _mark(sched, level: int, reasons: List[str]):
    sched.degraded = level > 0
    sched.fallback_level = level
    sched.degrade_reasons = list(reasons)
    return sched


def identity_schedule(scop, deps=None):
    """Rung 3: the program-order identity schedule — built row by row
    with *no* solver, LP or FM involved, so it cannot fail.  Always
    legal: it is the order the program text already executes in."""
    from fractions import Fraction

    from .scheduler import Schedule, ScheduleRow

    stmts = scop.statements
    maxd = max((s.dim for s in stmts), default=0)
    rows: Dict[int, List[ScheduleRow]] = {s.index: [] for s in stmts}
    bands: List[int] = []
    parallel: List[bool] = []
    for level in range(maxd + 1):
        for s in stmts:
            b = s.beta[level] if level < len(s.beta) else 0
            rows[s.index].append(ScheduleRow("scalar", {("cst",): Fraction(b)}))
        bands.append(2 * level)
        parallel.append(False)
        if level < maxd:
            for s in stmts:
                coeffs = ({("it", level): Fraction(1)} if level < s.dim else {})
                rows[s.index].append(ScheduleRow("linear", coeffs))
            bands.append(2 * level + 1)
            parallel.append(False)
    return Schedule(scop, rows, bands, parallel, set(), {}, [], True,
                    list(deps or []), {"fallback": True, "identity": True})


def _attach_tree(sched, deadline: Optional[Deadline]) -> None:
    """Rung acceptance includes the FM bound pass: a schedule whose tree
    cannot be built (an fm.bounds fault, an FM blowup) is not servable —
    the ladder steps down instead of letting the emitter crash later."""
    from .schedtree import schedule_tree

    if deadline is not None:
        deadline.check("schedtree")
    schedule_tree(sched)


def schedule_with_ladder(scop, config=None, engine: str = "lex",
                         deadline: Optional[Deadline] = None,
                         cache=None, with_tree: bool = False,
                         **kwargs):
    """Schedule ``scop``, degrading deterministically instead of raising.

    The only exceptions that escape are ``KeyboardInterrupt``/
    ``SystemExit`` — any other failure (injected fault, deadline breach,
    solver error, FM blowup, cache trouble) steps down the
    :data:`LADDER` until the identity rung, which cannot fail.

    ``cache`` (a ``schedcache.ScheduleCache``) serves rung 0 through the
    structural cache; degraded schedules are **never** published to it —
    a transient fault must not poison future compiles of the same kernel
    shape.  ``with_tree=True`` additionally requires the schedule tree
    to build (the AKG kernel-plan path), making tree construction part
    of each rung's acceptance test.
    """
    from .config import SchedulerConfig, pluto_style
    from .scheduler import PolyTOPSScheduler

    config = config or SchedulerConfig()
    reasons: List[str] = []

    # -- rung 0: the full configured schedule ------------------------------
    scheduler = PolyTOPSScheduler(scop, config, engine=engine,
                                  deadline=deadline, **kwargs)
    try:
        if cache is not None:
            from .schedcache import cached_schedule_scop
            sched = cached_schedule_scop(scop, config, engine=engine,
                                         cache=cache, with_tree=with_tree,
                                         deadline=deadline, **kwargs)
            if with_tree and getattr(sched, "_tree", None) is None:
                # cached_schedule_scop treats the tree as an optional
                # payload and swallows build failures; for the ladder
                # the tree is part of rung acceptance — force it so an
                # FM fault steps the ladder down instead of surfacing
                # later in the kernel-plan lowering
                _attach_tree(sched, deadline)
        else:
            sched = scheduler.schedule()
            if with_tree:
                _attach_tree(sched, deadline)
        return _mark(sched, 0, reasons)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # noqa: BLE001 — the ladder exists to catch all
        reasons.append(f"full: {type(e).__name__}: {e}")

    # -- rung 1: salvage the legal prefix already solved -------------------
    # Every dimension the scheduler completed is legality-constrained
    # (weak satisfaction of all active dependences), so any prefix
    # completed with the program-order suffix is a legal schedule; the
    # per-dim ILPs are per-SCC decomposed, so the prefix carries every
    # SCC result solved before the fault.
    try:
        sched = scheduler.partial_schedule()
        if sched is not None:
            if with_tree:
                _attach_tree(sched, deadline)
            return _mark(sched, 1, reasons)
        reasons.append("partial: no completed prefix to salvage")
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # noqa: BLE001
        reasons.append(f"partial: {type(e).__name__}: {e}")

    # -- rung 2: pluto-default strategy ------------------------------------
    try:
        sched = PolyTOPSScheduler(scop, pluto_style(), engine=engine,
                                  deadline=deadline).schedule()
        if with_tree:
            _attach_tree(sched, deadline)
        return _mark(sched, 2, reasons)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:  # noqa: BLE001
        reasons.append(f"pluto_default: {type(e).__name__}: {e}")

    # -- rung 3: program-order identity — cannot fail ----------------------
    deps = getattr(scheduler, "deps", None)
    sched = identity_schedule(scop, deps)
    if with_tree:
        try:
            _attach_tree(sched, None)   # identity trees are trivial FM
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001
            reasons.append(f"identity tree: {type(e).__name__}: {e}")
    return _mark(sched, 3, reasons)


def provenance(sched) -> Dict[str, Any]:
    """The degradation provenance of any Schedule (including ones
    unpickled from a pre-resilience cache, which lack the fields)."""
    level = int(getattr(sched, "fallback_level", 0))
    return {
        "degraded": bool(getattr(sched, "degraded", False)),
        "fallback_level": level,
        "rung": LADDER[level] if 0 <= level < len(LADDER) else str(level),
        "reasons": list(getattr(sched, "degrade_reasons", [])),
    }
