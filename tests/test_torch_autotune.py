"""The port's measured autotuner (``repro_torch.core.autotune``, with
``crunner``, ``ranker`` and ``schedcache``'s measurement pool) against
the reference's, the cases of ``tests/test_autotune.py`` and the
autotuner's failure policy of ``tests/test_resilience.py`` in the port:

* the static ranking (``measure=False``) and its winner equal the
  reference's;
* a measured winner is legal: its checksum matches the program-order
  C build's;
* faults injected at ``cc.compile``, ``cc.run`` and ``measure`` surface
  as typed ``MeasurementError``\\ s, are retried once and then excluded;
* a clean measured winner replays from the cache (memory, then disk)
  without enumerating anything;
* the measurement pool records, loads and compacts;
* ``fit_ranker`` on the same rows gives the reference's coefficients
  within 1e-12.

Every test points crunner's result cache and the schedule pool at its
own ``tmp_path``.
"""
from __future__ import annotations

import math
import shutil

import numpy as np
import pytest

from repro.core import autotune as jat
from repro.core import ranker as jrk
from repro.core import scops_polybench as jpb
from repro.core.schedcache import ScheduleCache as JCache
from repro_torch.core import autotune as tat
from repro_torch.core import config as CFG
from repro_torch.core import crunner
from repro_torch.core import ranker as trk
from repro_torch.core import scops_polybench as tpb
from repro_torch.core.cachemodel import CacheSpec
from repro_torch.core.resilience import (FAULT_SITES, REGISTRY, MeasurementError,
                                         inject)
from repro_torch.core.schedcache import (MEASUREMENTS_FILE, ScheduleCache,
                                         compact_measurements, load_measurements,
                                         record_measurements)
from repro_torch.core.scheduler import PolyTOPSScheduler, schedule_scop
from repro_torch.core.scop import Scop

HAVE_GCC = shutil.which("gcc") is not None
needs_gcc = pytest.mark.skipif(not HAVE_GCC, reason="no C compiler")
SCALARS = {"alpha": 1.5, "beta": 0.7, "zero": 0.0, "one": 1.0}

TINY_C = """
#include <stdio.h>
#define REPEATS 1
int main(void) {
    double acc = 0.0;
    for (int r = 0; r < REPEATS; ++r)
        for (int i = 0; i < 100; ++i) acc += (double)i;
    printf("TIME_S 0.05 CHECKSUM %.17g\\n", acc);
    return 0;
}
"""


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """crunner's result cache in the test's own directory; no armed
    fault leaks between tests."""
    monkeypatch.setattr(crunner, "CACHE_DIR", tmp_path / "cc")
    REGISTRY.reset()
    yield
    REGISTRY.reset()


def _square_scop():
    """A transposed accumulate: eight candidates (two bases, their tiles)."""
    s = Scop("square", params={"N": 16})
    with s.loop("i", 0, "N"):
        with s.loop("j", 0, "N"):
            s.stmt("C[i,j] = C[i,j] + A[i,j] * B[j,i]")
    return s


def _c_checksum(scop, tc=None):
    from repro_torch.core.cbackend import CCodeGenerator

    scalars = {k: v for k, v in SCALARS.items() if k in scop.scalars}
    if tc is None:     # untransformed program order: the oracle
        sched = PolyTOPSScheduler(scop, CFG.SchedulerConfig())._fallback_original()
        src = CCodeGenerator(sched, scalars=scalars).generate()
    else:
        sched = schedule_scop(scop, tc.scheduler_config())
        src = tat.build_source(scop, tc, sched, scalars)
    return crunner.compile_and_run(
        src, tag=f"at_{scop.name}_{tc.label if tc else 'orig'}",
        use_cache=False).checksum


def test_restored_fault_sites_and_versions():
    from repro.core import resilience as jres

    assert FAULT_SITES == jres.FAULT_SITES
    assert tat.SPACE_VERSION == jat.SPACE_VERSION
    assert crunner.CFLAGS == __import__("repro.core.crunner",
                                        fromlist=["CFLAGS"]).CFLAGS
    assert str(crunner.CACHE_DIR) != str(__import__(
        "repro.core.crunner", fromlist=["CACHE_DIR"]).CACHE_DIR)


@pytest.mark.parametrize("name,size", [("mvt", 48), ("jacobi1d", (4, 20))])
def test_static_ranking_equals_the_reference(name, size):
    """Two kernels here; the six frozen ``__autotune`` winners are held
    bit for bit at full size in ``test_torch_sched_golden.py``."""
    t = tat.autotune(tpb.REGISTRY[name](size), measure=False, use_cache=False,
                     cache=ScheduleCache(disk=False), spec=CacheSpec())
    from repro.core.cachemodel import CacheSpec as JSpec

    j = jat.autotune(jpb.REGISTRY[name](size), measure=False, use_cache=False,
                     cache=JCache(disk=False), spec=JSpec())
    assert t.ranked == j.ranked
    assert t.to_dict() == j.to_dict()
    assert (t.source, t.ranker) == ("static", "analytic")


@needs_gcc
def test_measured_winner_is_legal_and_replays(tmp_path, monkeypatch):
    """A measured winner checksum-matches the program-order build; the
    second call is a winner replay from memory, a third from disk, and
    neither enumerates, schedules or compiles anything."""
    cache = ScheduleCache(cache_dir=str(tmp_path / "pool"))
    r1 = tat.autotune(_square_scop(), measure=True, top_k=2, cache=cache)
    assert r1.source == "measured" and not r1.degraded
    assert r1.seconds is not None and r1.seconds > 0
    ref = _c_checksum(_square_scop())
    assert crunner.checksums_match(r1.checksum, ref, 1e-6)
    assert not [f for f in r1.failures if f["kind"] == "checksum_mismatch"]

    def boom(*a, **k):
        raise AssertionError("a cache hit must not re-enumerate")

    for fn in ("base_configs", "_schedules_for_space", "candidate_space",
               "build_source"):
        monkeypatch.setattr(tat, fn, boom)
    r2 = tat.autotune(_square_scop(), measure=True, top_k=2, cache=cache)
    assert r2.source == "cache"
    assert (r2.config, r2.ranked, r2.checksum) == (r1.config, r1.ranked, r1.checksum)
    cache2 = ScheduleCache(cache_dir=str(tmp_path / "pool"))
    r3 = tat.autotune(_square_scop(), measure=True, top_k=2, cache=cache2)
    assert r3.source == "cache" and r3.config == r1.config
    assert cache2.stats["disk_hits"] >= 1
    # every clean measurement became a training triple
    rows = load_measurements(cache, tat.SPACE_VERSION)
    assert rows and all(r["kernel"] == "square" and r["seconds"] > 0
                        and len(r["feats"]) == len(trk.FEATURE_NAMES)
                        and r["fv"] == trk.FEATURE_VERSION for r in rows)


@needs_gcc
@pytest.mark.parametrize("name,tc", [("gemm", ("pluto", 8, False)),
                                     ("jacobi1d", ("pluto", 8, True))])
def test_tiled_variant_matches_oracle(name, tc):
    small = {"gemm": lambda: tpb.make_gemm(40),
             "jacobi1d": lambda: tpb.make_jacobi1d((6, 44))}[name]
    ref = _c_checksum(small())
    strategy, tile, wavefront = tc
    got = _c_checksum(small(), tat.TunedConfig(strategy, tile=tile,
                                               wavefront=wavefront))
    assert crunner.checksums_match(got, ref, 1e-6)


@needs_gcc
def test_injected_cc_faults_are_typed():
    for site, phase in (("cc.compile", "compile"), ("cc.run", "run"),
                        ("measure", "measure")):
        with inject(site, times=1):
            with pytest.raises(MeasurementError) as ei:
                crunner.measure_source(TINY_C, tag="inj", use_cache=False)
        assert (ei.value.kind, ei.value.phase) == ("injected", phase), site


def _tiny_scop():
    """One statement, two distinct bases: three builds a search."""
    s = Scop("resil_v", params={"N": 64})
    with s.loop("i", 0, "N"):
        s.stmt("X[i] = X[i] * 2.0 + Y[i]")
    return s


@needs_gcc
@pytest.mark.parametrize("site", ["cc.compile", "cc.run", "measure"])
def test_transient_fault_is_retried_once(site):
    """One injected failure: recorded, retried after the backoff, and the
    search goes on clean."""
    with inject(site, times=1):
        res = tat.autotune(_tiny_scop(), measure=True, top_k=2, use_cache=False)
    assert res.source == "measured" and not res.degraded
    injected = [f for f in res.failures if f["kind"] == "injected"]
    assert len(injected) == 1 and injected[0]["attempt"] == 1
    assert REGISTRY.fired[site] == 1


@needs_gcc
@pytest.mark.parametrize("site", ["cc.compile", "cc.run", "measure"])
def test_persistent_fault_excludes_after_one_retry(site, tmp_path):
    """A fault on every attempt: each measurement is tried twice, then
    excluded; with no reference checksum the result is the degraded
    static winner, and it is never persisted."""
    cache = ScheduleCache(cache_dir=str(tmp_path / "pool"))
    with inject(site, times=-1):
        res = tat.autotune(_tiny_scop(), measure=True, top_k=2, cache=cache)
    assert res.degraded and res.source == "static"
    assert [f["attempt"] for f in res.failures] == [1, 2]
    assert all(f["kind"] == "injected" for f in res.failures)
    res2 = tat.autotune(_tiny_scop(), measure=False, cache=cache)
    assert res2.source != "cache"


@needs_gcc
def test_candidate_fault_is_excluded_not_fatal(monkeypatch):
    """The reference measures clean; one candidate fails both attempts:
    it is excluded and the best surviving candidate wins."""
    real = crunner.measure_source
    first = {}

    def flaky(source, tag="", **kw):
        if not tag.endswith("_orig") and not first:
            first["tag"] = tag
        if tag == first.get("tag"):
            raise MeasurementError("run_failed", tag=tag, phase="run")
        return real(source, tag=tag, **kw)

    monkeypatch.setattr(crunner, "measure_source", flaky)
    res = tat.autotune(_tiny_scop(), measure=True, top_k=2, use_cache=False)
    assert res.source == "measured" and not res.degraded
    assert [(f["tag"], f["attempt"]) for f in res.failures] == \
        [(first["tag"], 1), (first["tag"], 2)]
    assert res.config.label != first["tag"].removeprefix("tune_resil_v_")


def test_measurement_pool_records_loads_and_compacts(tmp_path):
    cache = ScheduleCache(cache_dir=str(tmp_path))
    rows = [{"kernel": "gemm", "label": "pluto", "feats": [1.0], "seconds": 0.5,
             "v": 2, "fv": 1},
            {"kernel": "gemm", "label": "tensor", "feats": [2.0], "seconds": 0.25,
             "v": 1, "fv": 1}]
    record_measurements(cache, rows)
    record_measurements(cache, [])            # no-op
    assert load_measurements(cache) == rows
    assert load_measurements(cache, space_version=2) == rows[:1]
    mem = ScheduleCache(disk=False)           # disk-less: no pool
    record_measurements(mem, rows)
    assert load_measurements(mem) == []
    with open(tmp_path / MEASUREMENTS_FILE, "a") as f:
        f.write('{"kernel": "trunc\n')       # torn line of a dying writer
    assert load_measurements(cache) == rows
    # a re-measurement supersedes its predecessor; order is recency
    newer = dict(rows[0], seconds=0.4)
    record_measurements(cache, [newer, {"weird": True}])
    assert compact_measurements(cache, force=True)
    got = load_measurements(cache)
    assert got == [{"weird": True}, rows[1], newer]
    assert (tmp_path / (MEASUREMENTS_FILE + ".lock")).exists()
    # size-triggered compaction keeps the file bounded
    for i in range(40):
        record_measurements(cache, [dict(rows[1], seconds=0.01 * i)], max_bytes=400)
    assert (tmp_path / MEASUREMENTS_FILE).stat().st_size < 1000
    assert load_measurements(cache)[-1]["seconds"] == pytest.approx(0.39)


def test_pool_read_fault_returns_empty(tmp_path):
    cache = ScheduleCache(cache_dir=str(tmp_path))
    record_measurements(cache, [{"v": 7, "kernel": "k", "label": "l",
                                 "feats": [0.0], "seconds": 1.0}])
    with inject("cache.read", times=1):
        assert load_measurements(cache, 7) == []
    assert len(load_measurements(cache, 7)) == 1


def _pool_rows(seed: int):
    rng = np.random.default_rng(seed)
    nf = len(trk.FEATURE_NAMES)
    rows = []
    for k in range(5):
        for j in range(14):
            feats = [float(x) for x in rng.normal(size=nf)]
            rows.append({"kernel": f"k{k}", "label": f"c{j}", "feats": feats,
                         "seconds": math.exp(1.5 * feats[0] - 0.5 * feats[3]
                                             + 0.1 * rng.normal()),
                         "v": 2, "fv": trk.FEATURE_VERSION})
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_ranker_equals_the_reference(seed):
    assert trk.FEATURE_NAMES == jrk.FEATURE_NAMES
    assert trk.FEATURE_VERSION == jrk.FEATURE_VERSION
    rows = _pool_rows(seed)
    t, j = trk.fit_ranker(rows), jrk.fit_ranker(rows)
    assert t is not None and j is not None
    np.testing.assert_allclose(t.weights, j.weights, rtol=0, atol=1e-12)
    probe = rows[3]["feats"]
    assert abs(t.predict(probe) - j.predict(probe)) <= 1e-12
    assert trk.fit_ranker(rows[:5]) is None and jrk.fit_ranker(rows[:5]) is None


def test_features_equal_the_reference():
    """The ranker's feature vector of every enumerated candidate of one
    kernel equals the reference's."""
    from repro.core.cachemodel import CacheSpec as JSpec

    tscop, jscop = tpb.make_gemm(48), jpb.make_gemm(48)
    tsch = tat._schedules_for_space(tscop, ScheduleCache(disk=False))
    jsch = jat._schedules_for_space(jscop, JCache(disk=False))
    tc, jc = tat.candidate_space(tscop, tsch), jat.candidate_space(jscop, jsch)
    assert [c.label for c in tc] == [c.label for c in jc]
    ttrip = {s.index: tat._stmt_trip(tscop, s) for s in tscop.statements}
    jtrip = {s.index: jat._stmt_trip(jscop, s) for s in jscop.statements}
    for a, b in zip(tc, jc):
        tcost = tat.static_cost(tscop, tsch[a.base], a, CacheSpec(), ttrip, {})
        jcost = jat.static_cost(jscop, jsch[b.base], b, JSpec(), jtrip, {})
        assert tcost == jcost
        assert trk.features(tscop, tsch[a.base], a, tcost, CacheSpec(), ttrip, {}) == \
            jrk.features(jscop, jsch[b.base], b, jcost, JSpec(), jtrip, {})
