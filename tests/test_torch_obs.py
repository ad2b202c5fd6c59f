"""The port's telemetry layer (``obs/``, copies of the reference's) and the
traced event engine (``netsim/events.py``) against the JAX package's: the
same recorded events give the same spans, metrics, report and Chrome trace
JSON, byte for byte (numpy and plain Python on both sides).  0.1 s of test
time in a 6-worker run of the whole suite.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as JO  # noqa: E402
from repro.fleet.cluster import ClusterConfig as JCfg, ClusterSim as JSim  # noqa: E402
from repro.netsim.events import EventQueue as JQueue  # noqa: E402
from repro.serving.engine import BatchCostModel as JBCM  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.fleet.cluster import ClusterConfig as TCfg, ClusterSim as TSim  # noqa: E402
from repro_torch.netsim.events import EventQueue as TQueue  # noqa: E402
from repro_torch.serving.engine import BatchCostModel as TBCM  # noqa: E402


def record(O, rec):
    """One fixed script of spans, instants, counters, gauges, histograms
    and time series on ``rec`` (a ``Recorder`` of package ``O``)."""
    tr, m = rec.tracer, rec.metrics
    root = tr.add("infer", 0.5, 2.5, clock="wall", tid="runtime", cat="runtime",
                  args={"splits": [3]})
    root.children.append(O.Span("stage0", 0.5, 1.0, "wall", "runtime", "runtime"))
    tr.add("flow", 0.0, 0.004, clock="sim", tid="net", cat="netsim",
           args={"bytes": 4096})
    tr.instant("drop", 0.001, clock="sim", tid="net", cat="fault")
    tr.extend([O.Span("hop0", 1.0, 1.25, "wall", "runtime", "runtime", {"cut": 3})])
    rng = np.random.default_rng(0)
    for i in range(50):
        m.counter("requests").inc()
        m.counter(O.labelled("runtime.fault.drop", k=i % 2)).inc(0.5)
        m.gauge("queue").set(i % 7)
        m.gauge("queue").add(1)
        m.histogram("latency_s").observe(float(rng.exponential(0.01)))
        m.histogram("bytes", bounds=[1e2, 1e3, 1e4]).observe(float(rng.integers(0, 20000)))
        m.record("fleet.p99_s", 0.05 * i, float(rng.random()))
        m.record(O.labelled("runtime.stage_s", k=i % 3), 0.01 * i, 1e-3 * i)
    return rec


def _chrome(rec, tmp_path, name, clock="both"):
    path = tmp_path / name
    rec.report().to_chrome_trace(str(path), clock=clock)
    return path.read_bytes()


def test_recorder_metrics_report_and_chrome_trace_equal(tmp_path):
    j, t = record(JO, JO.Recorder()), record(TO, TO.Recorder())
    assert t.enabled and t.window_s == j.window_s
    jm, tm = j.metrics, t.metrics
    assert tm.names() == jm.names()
    assert tm.series_names() == jm.series_names()
    assert json.dumps(tm.snapshot(), sort_keys=True) == json.dumps(jm.snapshot(), sort_keys=True)
    for name in tm.series_names():
        for a, b in zip(tm.timeseries(name), jm.timeseries(name)):
            assert a.tolist() == b.tolist()
    for p in (0, 50, 90, 99, 100):
        assert tm.get("latency_s").percentile(p) == jm.get("latency_s").percentile(p)
        assert tm.get("bytes").percentile(p) == jm.get("bytes").percentile(p)
    assert tm.get("latency_s").mean() == jm.get("latency_s").mean()
    jr, tr = j.report(), t.report()
    assert tr.counters() == jr.counters()
    assert tr.summary() == jr.summary()
    assert repr(tr) == repr(jr)
    for name in ("infer", "flow", "hop0"):
        assert tr.span_total_s(name) == jr.span_total_s(name)
    assert tr.window_percentile("fleet.p99_s", 99) == jr.window_percentile("fleet.p99_s", 99)
    for clock in ("both", "sim", "wall"):
        assert (_chrome(t, tmp_path, f"t_{clock}.json", clock)
                == _chrome(j, tmp_path, f"j_{clock}.json", clock))
    assert TO.chrome_events(t.tracer.spans) == JO.chrome_events(j.tracer.spans)
    assert TO.latency_buckets() == JO.latency_buckets()
    assert TO.labelled("a.b", z=1, a="x") == JO.labelled("a.b", z=1, a="x")


def test_null_recorder_surface():
    n = TO.NULL
    assert isinstance(n, TO.NullRecorder) and not n.enabled
    with n.tracer.span("x") as s:
        s.args["k"] = 1
    n.metrics.counter("c").inc()
    n.metrics.histogram("h").observe(1.0)
    n.metrics.record("s", 0.0, 1.0)
    assert n.tracer.wall_now() == 0.0 and n.metrics.snapshot() == {}
    assert n.report().counters() == JO.NULL.report().counters() == {}
    assert np.isnan(n.metrics.gauge("g").percentile(50))


def _queue_run(Queue, O):
    rec = O.Recorder()
    q = Queue(obs=rec)
    fired = []
    h = q.schedule(0.3, lambda: fired.append("cancelled"))
    q.schedule_named(0.1, lambda: fired.append("a"), "first")
    q.schedule(0.2, lambda: (fired.append("b"),
                             q.schedule_named(0.25, lambda: fired.append("c"), "nested")))
    h.cancel()
    assert q.peek() == 0.1 and not q.empty()
    q.run()
    assert q.empty() and q.peek() == float("inf")
    return fired, q.n_fired, q.n_cancelled, rec


def test_traced_event_queue_equals_the_reference(tmp_path):
    jf, jn, jc, jrec = _queue_run(JQueue, JO)
    tf, tn, tc, trec = _queue_run(TQueue, TO)
    assert (tf, tn, tc) == (jf, jn, jc) == (["a", "b", "c"], 3, 1)
    assert [(s.name, s.t0, s.t1, s.tid) for s in trec.tracer.spans] == \
        [(s.name.replace("repro.", "repro_torch."), s.t0, s.t1, s.tid)
         for s in jrec.tracer.spans]
    assert trec.report().counters() == jrec.report().counters()


def _cluster_trace(Sim, Cfg, BCM, O, path):
    rec = O.Recorder(window_s=0.01)
    sim = Sim(BCM(flops_per_item=2e8, flops_per_s=1e12), Cfg(2, 4, 2e-3), obs=rec)
    rng = np.random.default_rng(3)
    t = np.cumsum(rng.exponential(1 / 3000, 300))
    for i, ti in enumerate(t):
        sim.offer(i, float(ti), tx_s=1e-4, tx_bytes=1000)
    stats = sim.run()
    rec.report().to_chrome_trace(str(path), clock="sim")
    return stats, rec


def test_traced_cluster_export_is_the_reference_byte_for_byte(tmp_path):
    js, jrec = _cluster_trace(JSim, JCfg, JBCM, JO, tmp_path / "j.json")
    ts, trec = _cluster_trace(TSim, TCfg, TBCM, TO, tmp_path / "t.json")
    assert [(r.rid, r.latency_s) for r in ts.served] == \
        [(r.rid, r.latency_s) for r in js.served]
    assert trec.report().counters() == jrec.report().counters()
    assert trec.metrics.series_names() == jrec.metrics.series_names()
    for name in trec.metrics.series_names():
        assert (trec.metrics.timeseries(name)[1].tolist()
                == jrec.metrics.timeseries(name)[1].tolist())
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
