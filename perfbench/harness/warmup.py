"""Set-up traffic that captures the engine's bounded graph keys before the
window, driven through ``submit`` and ``tick`` alone.

The engine keys a decode graph by the kv bucket of the longest decoding
slot and a chunk graph by (rows, kv bucket of the chunk's end), buckets
being whole pages up to ``max_len``.  A request of p prompt tokens and two
new ones lands its last chunk at bucket(p) and makes one decode tick at
bucket(p + 1); requests submitted together in falling order decode one at
a time, so each such tick is at its own request's bucket.  The harness
reads the page from the engine and sees from its graph counts whether a
request added a key; where the first probe of a decode bucket adds none,
the engine does not key decode ticks by bucket and no more are probed."""
from __future__ import annotations

from typing import Iterable, List, Set, Tuple


def bucket(n: int, page: int, max_len: int) -> int:
    return min(-(-n // page) * page, max_len)


def tail_key(p: int, chunk: int, page: int, max_len: int):
    """The chunk key of a prompt's last chunk, or None for whole chunks."""
    return (p % chunk, bucket(p, page, max_len)) if p % chunk else None


def decode_prompts(lo: int, hi: int, chunk: int, page: int, max_len: int,
                   prefer: Iterable[int], avoid: Set[Tuple[int, int]]) -> List[int]:
    """For every decode bucket from bucket(lo) to bucket(hi), a prompt length
    whose decode tick lands there: a length of ``prefer`` (the traffic's own
    table) if one does, else whole chunks, else a ragged length whose last
    chunk's key is not in ``avoid`` (the keys the window has to meet fresh)."""
    prefer = sorted(set(prefer))
    out = []
    for b in range(bucket(lo, page, max_len), bucket(hi, page, max_len) + 1, page):
        cand = range(max(b - page, 1), min(b, max_len - 1))   # bucket(p + 1) == b
        pick = next((p for p in prefer if p in cand), None)
        if pick is None:
            pick = next((p for p in reversed(cand) if p % chunk == 0), None)
        if pick is None:
            pick = next(p for p in reversed(cand)
                        if tail_key(p, chunk, page, max_len) not in avoid)
        out.append(pick)
    return out


def prompts(mix, tables, page: int) -> Tuple[List[int], List[int]]:
    """The warm-up's prompt lengths: (served together first: the table's
    own lengths where the mix warms them, and the longest run of whole
    chunks; then one per decode bucket not among them)."""
    chunk, max_len = mix["chunk"], mix["max_len"]
    own = mix["warm_table"]
    avoid = set() if own else {
        k for k in (tail_key(p, chunk, page, max_len) for p in tables.prompt) if k}
    lo = min(tables.prompt) + 1
    hi = min(max(tables.prompt) + max(tables.output) - 1, max_len - 1)
    dec = decode_prompts(lo, hi, chunk, page, max_len, tables.prompt if own else [], avoid)
    first = set(tables.prompt) if own else set()
    first.add(chunk * (max(tables.prompt) // chunk))
    return sorted(first), [p for p in dict.fromkeys(dec) if p not in first]
