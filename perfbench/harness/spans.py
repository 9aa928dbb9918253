"""The program's own spans: the last recording session of the port's
tracer (``repro_torch.spans``), which records while the traced slice's
profiler runs, as plain data.  A program without the tracer gives None,
and so do the readers made of these.  Tests put hand-made sessions in
place of :func:`session`."""
from __future__ import annotations

import importlib.util
import statistics
from collections import defaultdict
from typing import Any, Dict, List, Optional


def session() -> Optional[Dict[str, Any]]:
    if importlib.util.find_spec("repro_torch.spans") is None:
        return None
    from repro_torch import spans
    return spans.last_session()


def traced(rec) -> Optional[List[Dict[str, Any]]]:
    """The spans of this run's traced part: those that started after the
    window closed (the traced slice or steps follow it)."""
    s = session()
    if s is None:
        return None
    w1 = rec["window"][1]
    return [sp for sp in s["spans"] if sp["t0"] >= w1]


def device_ms(sp: Dict[str, Any]) -> float:
    return (sp["d1"] - sp["d0"]) * 1e3


def median_ms(rec, name: str, **attrs) -> Optional[float]:
    """The median device time, in ms, of the traced spans of ``name``
    whose attributes hold ``attrs``."""
    got = traced(rec)
    ms = [device_ms(sp) for sp in got or () if sp["name"] == name and "d0" in sp
          and all(sp["attrs"].get(k) == v for k, v in attrs.items())]
    return statistics.median(ms) if ms else None


def step_median_ms(rec, name: str) -> Optional[float]:
    """The median over the traced steps (``train.step``) of the device
    time, in ms, of their spans of ``name``."""
    got = traced(rec) or ()
    steps = {sp["id"] for sp in got if sp["name"] == "train.step"}
    per: Dict[int, float] = defaultdict(float)
    for sp in got:
        if sp["name"] == name and sp["parent"] in steps and "d0" in sp:
            per[sp["parent"]] += device_ms(sp)
    return statistics.median(per.values()) if per else None
