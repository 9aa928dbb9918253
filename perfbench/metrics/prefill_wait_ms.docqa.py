"""prefill_wait_ms.docqa: the median wait, in ms, from a request's
admission into a slot to the launch of its first prompt chunk (the
program's ``Request.t_admit`` and ``t_prefill`` stamps, on the harness's
clock), over the requests whose first chunk was launched in the window."""
import statistics

from harness import window


def read(rec):
    if rec["kind"] != "serve":
        return None
    waits = [(lv.req.t_prefill - lv.req.t_admit) * 1e3 for lv in rec["requests"]
             if getattr(lv.req, "t_prefill", 0) and window.inside(rec, lv.req.t_prefill)]
    return statistics.median(waits) if waits else None
