"""Program spans, on one clock with the device.

A span is a named interval of the host on ``time.perf_counter()``, the
monotonic clock that a caller times its own window and ticks on, with the
id of the span it sits in and a few attributes (a tick's kind, rows, kv
bucket, a request's ``rid``).  A span that launches device work names the
device, and then also carries the device interval of that work: a pair of
timing CUDA events, taken from a pool, recorded on the current stream
around its body.  The first such span of a session records an anchor event
on the idle device and notes the host's time as it goes in; when the
session is read, every event becomes seconds on the host's clock through
that anchor, so device intervals and host spans share one timeline.  On the CPU a span's device interval is the
host interval of its eager body.

Recording is on while a ``torch.profiler`` session runs (:meth:`Tracer.on`
reads the profiler's flag once) and inside :func:`recording`.  Each
stretch of recording is one session, kept in memory in a bounded buffer
and read out as plain data by :func:`last_session`; nothing is written
while spans record.  Off, a span site costs that flag check and a test
that no session is open.  Spans never enter the profiler's trace as
``record_function`` ranges: the profiler mirrors those onto the device's
timeline, where they would read as device work.

The profiler is one per process, so the tracer is too (:data:`TRACER`).
It is not thread-safe: one thread records, the engine's or the trainer's.

    with spans.recording():
        engine.run()
    spans.write_chrome("trace.json", spans.last_session())
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 16           # spans a session keeps; later ones are counted as dropped
OUTSIDE = "(outside)"   # the label of time outside every span of a session


class _Off:
    """The span a site gets while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Session:
    """One stretch of recording: spans as lists
    ``[id, name, parent, t0, t1, attrs, start, end]``, where ``start`` and
    ``end`` are the device interval's events (``True`` for a span whose
    device interval is its host interval, None for a host span), and an
    anchor per CUDA device: (event, host seconds, error bound)."""

    def __init__(self):
        self.spans: List[list] = []
        self.dropped = 0
        self.stack: List[int] = []
        self.next_id = 0
        self.anchors: Dict[int, tuple] = {}


class _Span:
    __slots__ = ("tracer", "session", "rec", "stream")

    def __init__(self, tracer, session, rec, stream):
        self.tracer, self.session, self.rec, self.stream = tracer, session, rec, stream

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if self.stream is not None:
                rec[7] = self.tracer._event(self.stream)
            rec[4] = time.perf_counter()
        self.session.stack.pop()
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a tick's kind)."""
        if self.rec is not None:
            self.rec[5].update(attrs)


class Tracer:
    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.forced = 0
        self.live: Optional[_Session] = None    # the session spans go to
        self.last: Optional[_Session] = None    # the newest session, open or ended
        self.pool: Dict[int, list] = defaultdict(list)   # free events by device

    def on(self) -> bool:
        """Whether spans record: a ``torch.profiler`` session runs or a
        :meth:`recording` block is open."""
        return self.forced > 0 or _profiler._is_profiler_enabled

    def span(self, name: str, device: Optional[torch.device] = None, **attrs):
        """A span of ``name`` from this call to the end of its ``with``
        block.  With ``device``, also the device interval of the block's
        work there (none while a CUDA graph is being captured)."""
        if not self.on():
            if self.live is not None:
                self.live = None            # recording stopped: its session ended
            return _OFF
        s = self.live or self._begin()
        sid = s.next_id
        s.next_id += 1
        parent = s.stack[-1] if s.stack else -1
        s.stack.append(sid)
        if len(s.spans) >= self.cap:
            s.dropped += 1
            return _Span(self, s, None, None)
        rec = [sid, name, parent, time.perf_counter(), None, attrs, None, None]
        s.spans.append(rec)
        stream = None
        if device is not None:
            if device.type != "cuda":
                rec[6] = True
            elif not torch.cuda.is_current_stream_capturing():
                stream = torch.cuda.current_stream(device)
                self._anchor(s, stream)
                rec[6] = self._event(stream)
        return _Span(self, s, rec, stream)

    @contextmanager
    def recording(self):
        """Record in this block, in a session of its own (outside any
        profiler session that is running)."""
        if self.forced == 0:
            self._begin()
        self.forced += 1
        try:
            yield self
        finally:
            self.forced -= 1
            if self.forced == 0:
                self.live = None

    def _begin(self) -> _Session:
        old = self.last
        if old is not None:
            for rec in old.spans:
                for ev in rec[6:8]:
                    if isinstance(ev, torch.cuda.Event):
                        self.pool[ev.device.index].append(ev)
            for ev, _, _ in old.anchors.values():
                self.pool[ev.device.index].append(ev)
        self.live = self.last = _Session()
        return self.live

    def _event(self, stream) -> "torch.cuda.Event":
        free = self.pool[stream.device.index]
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _anchor(self, s: _Session, stream) -> None:
        """The session's anchor on ``stream``'s device: an event recorded
        on an idle device, which reaches it as the record returns; its host
        time is that moment.  Of three tries the narrowest is kept: the
        time from the record's call to the end of the wait for it bounds
        the error (a profiler running can slow the first records)."""
        idx = stream.device.index
        if idx in s.anchors:
            return
        tries = []
        for _ in range(3):
            torch.cuda.synchronize(stream.device)
            a = time.perf_counter()
            ev = self._event(stream)
            at = time.perf_counter()
            ev.synchronize()
            tries.append((time.perf_counter() - a, at, ev))
        width, at, ev = min(tries, key=lambda t: t[0])
        s.anchors[idx] = (ev, at, width)
        self.pool[idx] += [t[2] for t in tries if t[2] is not ev]

    def last_session(self) -> Optional[Dict[str, Any]]:
        """The newest session as plain data, or None: ``spans`` (each a dict
        of ``id``, ``name``, ``parent`` (-1 at the top), ``t0``, ``t1``,
        ``attrs`` and, with a device interval, ``d0`` and ``d1``, all in
        ``perf_counter`` seconds; spans still open are left out), ``dropped``
        (spans past the buffer's bound), ``anchors`` (by CUDA device, the
        seconds that bound the anchor's error) and ``gaps``
        (:func:`label_gaps`)."""
        s = self.last
        if s is None:
            return None
        for idx in s.anchors:
            torch.cuda.synchronize(idx)
        out = []
        for sid, name, parent, t0, t1, attrs, e0, e1 in s.spans:
            if t1 is None:
                continue
            d = {"id": sid, "name": name, "parent": parent, "t0": t0, "t1": t1,
                 "attrs": dict(attrs)}
            if e0 is True:
                d["d0"], d["d1"] = t0, t1
            elif e0 is not None and e1 is not None:
                anchor, host, _ = s.anchors[e0.device.index]
                d["d0"] = host + anchor.elapsed_time(e0) * 1e-3
                d["d1"] = host + anchor.elapsed_time(e1) * 1e-3
            out.append(d)
        return {"spans": out, "dropped": s.dropped, "gaps": label_gaps(out),
                "anchors": {idx: a[2] for idx, a in s.anchors.items()}}


def label_gaps(spans: List[Dict[str, Any]]) -> Dict[str, float]:
    """Seconds of the session's extent (its first span's start to its last
    span's end) outside every device interval, by the innermost host span
    the time falls in (:data:`OUTSIDE` where none)."""
    if not spans:
        return {}
    lo, hi = min(s["t0"] for s in spans), max(s["t1"] for s in spans)
    gaps, edge = [], lo
    for a, b in sorted((s["d0"], s["d1"]) for s in spans if "d0" in s):
        if a > edge:
            gaps.append((edge, min(a, hi)))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    # host spans of one thread nest: a sweep over their ends keeps the
    # stack of spans open at each moment, the innermost last
    marks = sorted([(s["t0"], 1, i) for i, s in enumerate(spans) if s["t1"] > s["t0"]]
                   + [(s["t1"], 0, i) for i, s in enumerate(spans) if s["t1"] > s["t0"]])
    out: Dict[str, float] = defaultdict(float)
    stack: List[int] = []
    j = 0

    def move(mark):
        if mark[1]:
            stack.append(mark[2])
        else:
            stack.remove(mark[2])

    for a, b in gaps:
        while j < len(marks) and marks[j][0] <= a:
            move(marks[j])
            j += 1
        cur = a
        while j < len(marks) and marks[j][0] < b:
            out[spans[stack[-1]]["name"] if stack else OUTSIDE] += marks[j][0] - cur
            cur = marks[j][0]
            move(marks[j])
            j += 1
        out[spans[stack[-1]]["name"] if stack else OUTSIDE] += b - cur
    return dict(out)


def chrome_trace(session: Dict[str, Any]) -> Dict[str, Any]:
    """A session as Chrome-trace JSON: host spans on one row, device
    intervals on another, microseconds from the session's first span."""
    spans = session["spans"]
    base = min((s["t0"] for s in spans), default=0.0)
    events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": row}}
              for tid, row in ((0, "host"), (1, "device"))]
    for s in spans:
        args = {"id": s["id"], "parent": s["parent"], **s["attrs"]}
        for tid, a, b in ((0, "t0", "t1"), (1, "d0", "d1")):
            if a in s:
                events.append({"name": s["name"], "ph": "X", "pid": 0, "tid": tid,
                               "ts": (s[a] - base) * 1e6, "dur": (s[b] - s[a]) * 1e6,
                               "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped": session["dropped"], "gaps_s": session["gaps"]}}


def write_chrome(path: str, session: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(session), f)


TRACER = Tracer()
span = TRACER.span
recording = TRACER.recording
last_session = TRACER.last_session
