# Copied from src/repro/fleet/vectorized.py.
"""Vectorized arrival-level cluster engine — the fleet-scale fast path.

``repro_torch.fleet.cluster.ClusterSim`` steps one Python event per request,
which is the right *semantic authority* but tops out around thousands of
clients.  This module replays the exact same admission-queue + dynamic-
batching + replica state machine over whole NumPy arrival arrays:

* arrivals are sorted once and admitted in *runs* (every arrival between
  two state-changing events is one ``searchsorted`` slice, with drops
  decided by a queue-headroom count, not per-request branches);
* replica availability is a running k-server assignment (a k-entry heap
  of done-times — never one heap entry per request);
* the saturated regime (window overdue, all replicas busy, a full batch
  plus spare waiting) collapses to a closed form: dispatch times follow
  the max-plus cadence ``d_j = h_sorted[j mod k] + floor(j/k) * svc_B``,
  per-arrival dispatch counts broadcast over the k arithmetic
  progressions, and the drop decision ``A_{i+1} = min(A_i + 1, H_i)``
  (``H_i`` = queue headroom, a non-decreasing prefix quantity) is solved
  loop-free with ``np.minimum.accumulate`` — the queue-depth prefix
  scan.  Whole saturated stretches commit in O(arrivals/CHUNK) python
  iterations.

With the stock :class:`~repro_torch.serving.engine.BatchCostModel` service
times are a deterministic function of batch size, so the replay is
*exact*: identical drop decisions, batch boundaries, and dispatch/done
times (modulo float accumulation order — see :data:`PCTL_RTOL`).  The
``check_event_engine=True`` path re-runs the event engine on the same
offers and asserts drop counts / batch counts match exactly and latency
percentiles agree within the documented tolerance.  That is the PR-5
screen/refine contract applied to the cluster: this engine screens,
``ClusterSim`` stays the single semantic authority and refines
survivors (see ``DeploymentPlanner.search(engine=...)``).

For the overload regime where per-request identity stops mattering,
:func:`fluid_cluster_stats` integrates a mean-field fluid (binned
Lindley) recurrence instead — O(n_bins) memory and time, approximate by
construction, selected by ``mode="auto"`` only under gross sustained
overload.

Stats come back on the same ``ClusterStats`` surface (``percentile``,
``drop_fraction``, ``mean_batch``, ``utilization``) as
:class:`VectorClusterStats` (per-request NumPy arrays, offer order) or,
with ``streaming=True``, :class:`StreamingClusterStats` — a fixed-bucket
histogram instead of per-request records, so retained memory stays
O(histogram) at 10^6+ requests.  When an enabled recorder is passed the
windowed ``fleet.*`` time series (see CONTRIBUTING's reference table)
are reconstructed from the arrays, so the observability layer works at
scale without per-event spans.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.fleet.cluster import (ClusterConfig, ClusterSim, RequestRecord)
from repro_torch.obs import NULL
from repro_torch.obs.metrics import Histogram
from repro_torch.serving.engine import BatchCostModel

INF = float("inf")

#: Documented agreement tolerance for latency percentiles between the
#: vectorized and event engines.  Both compute the same real numbers;
#: they differ only in float accumulation order (the event engine chains
#: ``now + svc`` additively, the closed form multiplies out the cadence),
#: so the relative gap is bounded by accumulated rounding, far below
#: this.  Drop / batch / served counts carry no tolerance: they must be
#: exact in the deterministic-service case.
PCTL_RTOL = 1e-6
PCTL_ATOL = 1e-9

#: ``mode="auto"`` falls back to the mean-field fluid model only when the
#: run is big enough that per-request identity is unaffordable AND the
#: offered load exceeds capacity by this factor (deep overload: the
#: queue pegs at its limit and latency saturates, which is exactly where
#: the fluid limit is accurate).
FLUID_OVERLOAD_FACTOR = 3.0
FLUID_MIN_REQUESTS = 200_000

# Saturated-stretch lookahead (arrivals per closed-form commit).  Bounds
# the wasted work when a stretch breaks early; large stretches re-enter
# the fast path immediately, so throughput is O(n / CHUNK) commits.
_CHUNK = 8192

# Cap on the number of windowed telemetry samples reconstructed from a
# vectorized run (the event engine emits one sample per window *event*;
# at mega-fleet horizons that would itself be millions of rows).
_MAX_WINDOWS = 20_000


# ======================================================================
# stats surfaces
# ======================================================================

class VectorClusterStats:
    """``ClusterStats`` read surface over per-request NumPy arrays.

    Arrays are in *offer order* (the order requests were offered, which
    is also rid order when rids were auto-assigned).  ``t_dispatch`` /
    ``t_done`` are ``-1.0`` for dropped requests.
    """

    def __init__(self, rids, t_offer, t_dispatch, t_done, drop_mask,
                 batches: int, busy_s: float):
        self.rids = rids
        self.t_offer = t_offer
        self.t_dispatch = t_dispatch
        self.t_done = t_done
        self.drop_mask = drop_mask
        self.dropped = int(drop_mask.sum())
        self.batches = batches
        self.busy_s = busy_s

    # -------------------------------------------------- ClusterStats API
    @property
    def n_served(self) -> int:
        return len(self.t_offer) - self.dropped

    def latencies(self) -> np.ndarray:
        m = ~self.drop_mask
        return self.t_done[m] - self.t_offer[m]

    def waits(self) -> np.ndarray:
        m = ~self.drop_mask
        return self.t_dispatch[m] - self.t_offer[m]

    def percentile(self, p: float) -> float:
        lat = self.latencies()
        return float(np.percentile(lat, p)) if len(lat) else float("nan")

    def drop_fraction(self) -> float:
        n = len(self.t_offer)
        return self.dropped / n if n else 0.0

    def mean_batch(self) -> float:
        return self.n_served / self.batches if self.batches \
            else float("nan")

    def utilization(self, n_replicas: int, horizon_s: float) -> float:
        return self.busy_s / (n_replicas * horizon_s) if horizon_s > 0 \
            else 0.0

    @property
    def served(self) -> list:
        """Materialized ``RequestRecord`` list (event-engine compat).

        O(n) python objects — debugging/refinement aid, never built on
        the mega-fleet path."""
        m = ~self.drop_mask
        return [RequestRecord(int(r), float(t), float(d), float(o))
                for r, t, d, o in zip(self.rids[m], self.t_offer[m],
                                      self.t_dispatch[m], self.t_done[m])]

    def __repr__(self):
        return (f"VectorClusterStats(n={len(self.t_offer)}, "
                f"served={self.n_served}, dropped={self.dropped}, "
                f"batches={self.batches})")


class StreamingClusterStats:
    """``ClusterStats`` surface with O(histogram) memory: latency
    quantiles come from a streaming fixed-bucket histogram (the same
    :class:`repro_torch.obs.metrics.Histogram` the windowed sampler uses), not
    from retained per-request records.

    Percentiles interpolate within log-spaced buckets, so they carry the
    standard telemetry quantile error (one bucket ratio, ~29% worst
    case at 9 buckets/decade) on top of :data:`PCTL_RTOL`; counts
    (served / dropped / batches) remain exact when produced by the exact
    engine, approximate when produced by the fluid model.
    """

    def __init__(self, hist: Histogram, n_served: int, dropped: int,
                 batches: int, busy_s: float):
        self.hist = hist
        self.n_served = n_served
        self.dropped = dropped
        self.batches = batches
        self.busy_s = busy_s

    def latencies(self) -> np.ndarray:
        raise RuntimeError(
            "StreamingClusterStats keeps no per-request records; use "
            "percentile()/mean_latency_s(), or rerun without "
            "streaming=True")

    def mean_latency_s(self) -> float:
        return self.hist.mean()

    def percentile(self, p: float) -> float:
        return self.hist.percentile(p)

    def drop_fraction(self) -> float:
        n = self.n_served + self.dropped
        return self.dropped / n if n else 0.0

    def mean_batch(self) -> float:
        return self.n_served / self.batches if self.batches \
            else float("nan")

    def utilization(self, n_replicas: int, horizon_s: float) -> float:
        return self.busy_s / (n_replicas * horizon_s) if horizon_s > 0 \
            else 0.0

    def __repr__(self):
        return (f"StreamingClusterStats(served={self.n_served}, "
                f"dropped={self.dropped}, batches={self.batches})")


# ======================================================================
# the exact vectorized replay
# ======================================================================

def _service_lut(cost: BatchCostModel, max_batch: int) -> np.ndarray:
    return np.array([0.0] + [cost.service_time(b)
                             for b in range(1, max_batch + 1)])


def _simulate_sorted(t: np.ndarray, cost: BatchCostModel,
                     cfg: ClusterConfig):
    """Replay the ``ClusterSim`` state machine over sorted arrivals.

    Returns ``(t_dispatch, t_done, drop_mask, batches, busy_s,
    batch_t, batch_n)`` aligned with ``t`` (sorted order).  Exact twin
    of the event engine for deterministic service times; the per-event
    invariants mirrored here are spelled out next to each branch.
    """
    import heapq as hq

    n = len(t)
    B, L = cfg.max_batch, cfg.queue_limit
    k, wnd = cfg.n_replicas, cfg.batch_window_s
    svc = _service_lut(cost, B)
    svc_b = float(svc[B])

    disp = np.empty(n)       # dropped slots set to -1.0 on return
    done = np.empty(n)
    drop = np.zeros(n, bool)
    adm = np.empty(n, np.int64)      # admitted arrival indices, FIFO
    na = 0                           # tail of the admitted buffer
    h = 0                            # head: adm[h:na] is the queue
    heap: list = []                  # done-times of the busy replicas
    free = k
    timer = INF                      # live window deadline (INF = none)
    due = False                      # window expired with work waiting
    i = 0                            # next arrival (sorted order)
    batches = 0
    busy = 0.0
    bt: list = []                    # per-batch dispatch times
    bn: list = []                    # per-batch sizes
    # adaptive saturated-stretch lookahead: sized to the observed commit
    # length so the per-commit array work tracks arrivals committed, not
    # arrivals scanned
    bulk_chunk = min(_CHUNK, max(2 * B * k, 1024))
    ar_buf = np.arange(min(n + 1, bulk_chunk + 1))   # grown on demand

    # python-float service LUT: the per-event fallback path below stays
    # numpy-free per iteration (no scalar boxing)
    svc_f = svc.tolist()

    def dispatch_ready(now: float):
        # mirror of ClusterSim._dispatch_ready: start batches while a
        # replica is free and one is ready (full, or window overdue).
        # disp/done times are not written here: batches consume adm[]
        # contiguously, so one np.repeat pass at the end covers every
        # dispatch in FIFO order.
        nonlocal free, h, batches, busy, due, timer
        while free and na > h and (due or na - h >= B):
            b = min(B, na - h)
            s = svc_f[b]
            hq.heappush(heap, now + s)
            free -= 1
            h += b
            batches += 1
            busy += s
            bt.append(now)
            bn.append(b)
        if na == h:                  # queue drained: window moot
            due = False
            timer = INF

    while i < n or h < na or heap:
        next_arr = t[i] if i < n else INF
        next_done = heap[0] if heap else INF

        # ---------------------------------------- saturated fast path --
        # Window overdue + every replica busy + at least one full batch
        # and one spare waiting: every done-event dispatches a full
        # batch, so dispatch times follow the k-server max-plus cadence
        # and whole stretches commit in closed form.
        if due and free == 0 and na - h >= B + 1:
            w0 = na - h
            hs = np.sort(np.asarray(heap))
            m_all = n - i
            m_c = min(m_all, bulk_chunk)
            ta = t[i:i + m_c]
            # Dispatch cadence: every done-event redispatches its
            # replica, so replica c's done-times form the arithmetic
            # progression h_c + m * svc_B.  Every running batch was
            # dispatched before the next event and finishes after it,
            # so the k done-times span less than one svc_B — which
            # makes the round-robin merge d_j globally sorted, i.e. the
            # true time-ordered dispatch schedule.  j range is supply-
            # bounded (admissions <= arrivals), so the stretch-break
            # test below is guaranteed to fail inside it.
            j_hi = (w0 + m_c) // B + 2
            jj = np.arange(j_hi + k)
            d = hs[jj % k] + (jj // k) * svc_b
            p_at_d = np.searchsorted(ta, d[:j_hi], side="right")
            if m_c:
                if len(ar_buf) < m_c + 1:
                    ar_buf = np.arange(min(n, 2 * m_c) + 1)
                ar = ar_buf[:m_c]
                idx1 = ar_buf[1:m_c + 1]
                # dispatches strictly before each arrival, from the
                # monotone inverse already in hand: p_at_d maps each
                # dispatch to its arrival position, so a bincount +
                # cumsum recovers the per-arrival dispatch count without
                # an O(m log j) search (d_j < ta_i <=> p_at_d[j] <= i)
                d_cnt = np.cumsum(np.bincount(
                    p_at_d, minlength=m_c + 1))[:m_c]
                # queue-depth prefix scan: admissions A satisfy
                # A_{i+1} = A_i + [A_i < H_i] with headroom
                # H_i = L - W0 + B * D_i non-decreasing, which unrolls
                # to A_i = min(i, min_{j<i} H_j + i - 1 - j)
                head = d_cnt * B
                head += (L - w0) - ar
                m_run = np.minimum.accumulate(head)
                m_run += idx1
                acum = np.empty(m_c + 1, np.int64)
                acum[0] = 0
                np.minimum(idx1, m_run - 1, out=acum[1:])
            else:
                ta = np.empty(0)
                acum = np.zeros(1, np.int64)
                p_at_d = np.zeros(j_hi, np.int64)
            w_at_d = w0 + acum[p_at_d] - B * jj[:j_hi]
            # stretch holds while each dispatch is full AND leaves work
            # (>= B+1 waiting), so `due` never resets mid-stretch
            ok = w_at_d >= B + 1
            if m_c < m_all:
                ok &= d[:j_hi] <= ta[-1]   # arrivals past chunk unmodeled
            jstar = int(np.argmin(ok)) if not ok.all() else j_hi
            # ok[0] always holds (w0 >= B+1), so jstar >= 1: progress
            pstar = int(np.searchsorted(ta, d[jstar], side="right"))
            # stretch ended at the lookahead cap, not a real queue dip:
            # widen the next lookahead; otherwise track the commit size
            if jstar < j_hi and w_at_d[jstar] >= B + 1:
                bulk_chunk = min(bulk_chunk * 4, 1 << 20)
            else:
                bulk_chunk = min(1 << 20, max(2 * B * k, 1024,
                                              pstar + (pstar >> 1)))
            n_new = int(acum[pstar])
            if pstar:
                admitted = acum[1:pstar + 1] > acum[:pstar]
                adm[na:na + n_new] = i + np.nonzero(admitted)[0]
                na += n_new
                drop[i:i + pstar] = ~admitted
                i += pstar
            h += B * jstar
            batches += jstar
            busy += jstar * svc_b
            bt.extend(d[:jstar].tolist())
            bn.extend([B] * jstar)
            # outstanding done-times after j* dispatches are exactly the
            # next k cadence entries (d_{j+k} = d_j + svc_B)
            heap[:] = d[jstar:jstar + k].tolist()
            continue

        # ------------------------------------------------- arrivals ----
        # Arrival events were all scheduled before run(), so they carry
        # the lowest sequence numbers and win every time tie.
        if i < n and next_arr <= next_done and next_arr <= timer:
            if na == h:
                # empty queue (=> no live timer, not due).  Mirrors
                # _on_arrival: drop check, append, then either the full-
                # batch dispatch branch (B == 1) or arm the window.
                now = float(next_arr)
                if L < 1:
                    drop[i] = True
                    i += 1
                    continue
                adm[na] = i
                na += 1
                i += 1
                if na - h >= B:
                    dispatch_ready(now)
                else:
                    timer = now + wnd
                continue
            # queue non-empty: admit a whole run of arrivals up to the
            # next state-changing event.  Arrivals at exactly t_stop are
            # included (they outrank the timer/done event in seq order).
            t_stop = min(timer, next_done)
            j_stop = i + int(np.searchsorted(t[i:], t_stop, side="right"))
            m = j_stop - i
            if due or free == 0:
                # nothing can dispatch on arrival (due => all busy; all
                # busy => the >=B dispatch branch is a no-op) and no new
                # timers are armed: pure admit/drop counting
                room = max(L - (na - h), 0)
                n_adm = min(m, room)
                if n_adm:
                    adm[na:na + n_adm] = np.arange(i, i + n_adm)
                    na += n_adm
                if n_adm < m:
                    drop[i + n_adm:j_stop] = True
                i = j_stop
                continue
            # free > 0, not due => waiting < B (else it would have
            # dispatched) and a timer is live.  Admissions can trigger a
            # full-batch dispatch mid-run.
            room_drop = L - (na - h)
            room_disp = B - (na - h)
            if room_drop <= 0:           # L < B and queue pegged at L
                drop[i:j_stop] = True
                i = j_stop
                continue
            if m < min(room_disp, room_drop):
                adm[na:na + m] = np.arange(i, i + m)
                na += m
                i = j_stop
                continue
            if room_drop < room_disp:    # L < B: fill to L, drop rest
                adm[na:na + room_drop] = np.arange(i, i + room_drop)
                na += room_drop
                drop[i + room_drop:j_stop] = True
                i = j_stop
                continue
            # the (na-h+room_disp)-th admission completes a full batch
            adm[na:na + room_disp] = np.arange(i, i + room_disp)
            na += room_disp
            now = float(t[i + room_disp - 1])
            i += room_disp
            dispatch_ready(now)
            continue

        # ------------------------------------------- done / window -----
        if heap and next_done <= timer:
            now = hq.heappop(heap)
            free += 1
            dispatch_ready(now)
            continue
        if timer < INF:
            now = timer
            timer = INF
            due = True
            dispatch_ready(now)
            continue
        raise RuntimeError("vectorized cluster replay stalled "
                           "(invariant violation)")     # pragma: no cover

    # one deferred pass writes every dispatch/done time: the taken
    # prefix of adm[] is exactly the concatenation of all batches in
    # dispatch order
    bt_a = np.asarray(bt)
    bn_a = np.asarray(bn, np.int64)
    taken = adm[:h]
    disp[taken] = np.repeat(bt_a, bn_a)
    done[taken] = np.repeat(bt_a + svc[bn_a], bn_a)
    disp[drop] = -1.0
    done[drop] = -1.0
    return disp, done, drop, batches, busy, bt_a, bn_a


# ======================================================================
# public entry points
# ======================================================================

def simulate_cluster_vectorized(times, cost: BatchCostModel,
                                cfg: ClusterConfig, *, rids=None,
                                tx_s=None, tx_bytes=None, obs=None,
                                window_s=None, streaming: bool = False,
                                mode: str = "exact",
                                check_event_engine: bool = False,
                                pctl_rtol: float = PCTL_RTOL):
    """Run the vectorized cluster engine over an arrival-time array.

    ``times`` is per-request arrival times at the admission queue (any
    order; offer order is preserved on the stats arrays).  ``mode`` is
    ``"exact"`` (the replay), ``"fluid"`` (mean-field), or ``"auto"``
    (exact unless the run is both huge and deeply overloaded — see
    :data:`FLUID_OVERLOAD_FACTOR`).  ``tx_s`` / ``tx_bytes`` are the
    optional per-request wire metadata ``ClusterSim.offer`` takes; they
    feed the ``fleet.inflight_bytes`` series.  With
    ``check_event_engine=True`` the event engine re-runs the same offers
    and exact-count / percentile agreement is asserted.
    """
    obs = NULL if obs is None else obs
    times = np.asarray(times, float)
    n = len(times)
    rids_a = np.arange(n, dtype=np.int64) if rids is None \
        else np.asarray(rids, np.int64)

    if mode == "auto":
        mode = "fluid" if _deep_overload(times, cost, cfg) else "exact"
    if mode == "fluid":
        if check_event_engine:
            raise ValueError("check_event_engine requires mode='exact': "
                             "the fluid model is approximate by design")
        return fluid_cluster_stats(times, cost, cfg, obs=obs,
                                   window_s=window_s)
    if mode != "exact":
        raise ValueError(f"unknown mode {mode!r}")

    # trace generators emit sorted arrivals; skip the argsort round-trip
    presorted = n < 2 or bool((times[1:] >= times[:-1]).all())
    if presorted:
        ts = times
    else:
        order = np.argsort(times, kind="stable")   # stable = seq order
        ts = times[order]
    disp_s, done_s, drop_s, batches, busy, bt, bn = \
        _simulate_sorted(ts, cost, cfg)

    if presorted:
        disp, done, drop_mask = disp_s, done_s, drop_s
    else:
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        disp, done = disp_s[inv], done_s[inv]
        drop_mask = drop_s[inv]
    stats = VectorClusterStats(rids_a, times, disp, done, drop_mask,
                               batches, busy)

    if obs.enabled and n:
        _emit_series(obs, window_s if window_s is not None
                     else obs.window_s, ts, done_s, drop_s, bt, bn,
                     cfg, _service_lut(cost, cfg.max_batch),
                     times, tx_s, tx_bytes,
                     disp_sorted_adm=disp_s[~drop_s])
    if check_event_engine:
        check_against_event_engine(times, cost, cfg, stats,
                                   rids=rids_a, pctl_rtol=pctl_rtol)
    if streaming:
        return _to_streaming(stats)
    return stats


def check_against_event_engine(times, cost: BatchCostModel,
                               cfg: ClusterConfig, vstats, *, rids=None,
                               pctl_rtol: float = PCTL_RTOL,
                               pctl_atol: float = PCTL_ATOL) -> None:
    """Assert the event engine agrees with a vectorized run.

    Drop / served / batch counts must match exactly (deterministic
    service); latency percentiles must agree within ``pctl_rtol`` /
    ``pctl_atol`` (float accumulation order only).  O(n log n) python
    events — meant for small fleets and CI, not the mega-fleet path.
    """
    times = np.asarray(times, float)
    rids = np.arange(len(times)) if rids is None else rids
    sim = ClusterSim(cost, cfg)
    for r, tt in zip(rids, times):
        sim.offer(int(r), float(tt))
    est = sim.run()
    if est.dropped != vstats.dropped:
        raise AssertionError(
            f"drop count mismatch: event={est.dropped} "
            f"vectorized={vstats.dropped}")
    if est.batches != vstats.batches:
        raise AssertionError(
            f"batch count mismatch: event={est.batches} "
            f"vectorized={vstats.batches}")
    if len(est.served) != vstats.n_served:
        raise AssertionError(
            f"served count mismatch: event={len(est.served)} "
            f"vectorized={vstats.n_served}")
    for p in (50.0, 95.0, 99.0):
        a, b = est.percentile(p), vstats.percentile(p)
        if np.isnan(a) and np.isnan(b):
            continue
        if abs(a - b) > pctl_atol + pctl_rtol * max(abs(a), abs(b)):
            raise AssertionError(
                f"p{p:g} mismatch beyond tolerance: event={a!r} "
                f"vectorized={b!r}")


def _deep_overload(times: np.ndarray, cost: BatchCostModel,
                   cfg: ClusterConfig) -> bool:
    n = len(times)
    if n < FLUID_MIN_REQUESTS:
        return False
    horizon = float(times.max() - min(float(times.min()), 0.0))
    if horizon <= 0:
        return False
    capacity = cfg.n_replicas * cfg.max_batch \
        / cost.service_time(cfg.max_batch)
    return (n / horizon) > FLUID_OVERLOAD_FACTOR * capacity


def _to_streaming(stats: VectorClusterStats) -> StreamingClusterStats:
    hist = Histogram("cluster.latency_s")
    lat = stats.latencies()
    if len(lat):
        idx = np.searchsorted(np.asarray(hist.bounds), lat, side="left")
        counts = np.bincount(idx, minlength=len(hist.counts))
        hist.counts = counts.tolist()
        hist.n = int(len(lat))
        hist.total = float(lat.sum())
        hist.vmin = float(lat.min())
        hist.vmax = float(lat.max())
    return StreamingClusterStats(hist, stats.n_served, stats.dropped,
                                 stats.batches, stats.busy_s)


# ======================================================================
# windowed decision signals (engine-agnostic)
# ======================================================================

def signals_at(t: float, *, t_offer, t_dispatch, t_done, drop_mask,
               window_s: float, t_prev: Optional[float] = None) -> dict:
    """The adaptive controller's decision signals at simulated time
    ``t``, computed from per-request arrays.

    Both cluster engines can produce these arrays (the vectorized stats
    carry them natively; event-engine records convert trivially), and
    because the vectorized replay is an exact twin of the event engine,
    every *count* here — arrivals, drops, queue depth — is identical
    whichever engine produced the arrays.  That is what makes controller
    decisions engine-independent: drift detection keys on the exact
    integer signals, never on float-accumulation-sensitive quantities.

    Windows: arrival-side signals count offers in ``(t - window_s, t]``;
    completion-side signals (the latency percentiles) take requests done
    in ``(t_prev, t]`` (``t_prev`` defaults to ``t - window_s``).
    Only offers with ``t_offer <= t`` are considered, so a prefix replay
    and an incrementally-run event engine agree by causality.
    """
    t_offer = np.asarray(t_offer, float)
    t_dispatch = np.asarray(t_dispatch, float)
    t_done = np.asarray(t_done, float)
    drop_mask = np.asarray(drop_mask, bool)
    t_lo = t - window_s
    t_prev = t_lo if t_prev is None else t_prev

    past = t_offer <= t
    in_win = past & (t_offer > t_lo)
    n_arr = int(in_win.sum())
    n_drop = int((in_win & drop_mask).sum())
    adm = past & ~drop_mask
    depth = int((adm & (t_dispatch > t)).sum())
    inflight = int((adm & (t_dispatch <= t) & (t_done > t)).sum())
    done_win = adm & (t_done > t_prev) & (t_done <= t)
    lat = t_done[done_win] - t_offer[done_win]
    return {
        "t": t,
        "arrivals": n_arr,
        "rate_hz": n_arr / window_s if window_s > 0 else 0.0,
        "drops": n_drop,
        "drop_fraction": n_drop / n_arr if n_arr else 0.0,
        "queue_depth": depth,
        "inflight": inflight,
        "n_done": int(done_win.sum()),
        "p50_s": float(np.percentile(lat, 50)) if len(lat) else float("nan"),
        "p99_s": float(np.percentile(lat, 99)) if len(lat) else float("nan"),
    }


# ======================================================================
# mean-field fluid fallback
# ======================================================================

def fluid_cluster_stats(times, cost: BatchCostModel, cfg: ClusterConfig,
                        *, obs=None, window_s=None,
                        n_bins: int = 2048) -> StreamingClusterStats:
    """Mean-field (binned Lindley) fluid model of the cluster.

    Arrivals are binned; each bin moves fluid through
    ``Q' = Q + A - served`` with ``served = min(mu * dt, Q + A)`` at full
    service rate ``mu = k * B / svc(B)``, and queue mass above
    ``queue_limit`` overflows as drops.  Per-bin latency is approximated
    as ``Q/mu + svc(b̂) + window/2`` with ``b̂`` the fluid batch size.
    O(n_bins) regardless of request count; accurate in deep sustained
    overload (where waits are queue-dominated and batches run full),
    approximate elsewhere — which is why ``mode="auto"`` only selects it
    there.  Counts are rounded fluid masses, not per-request decisions.
    """
    obs = NULL if obs is None else obs
    times = np.asarray(times, float)
    hist = Histogram("cluster.latency_s")
    n = len(times)
    if n == 0:
        return StreamingClusterStats(hist, 0, 0, 0, 0.0)

    k, big_b, wnd = cfg.n_replicas, cfg.max_batch, cfg.batch_window_s
    svc_b = cost.service_time(big_b)
    mu = k * big_b / svc_b                      # req/s, batches full
    t_lo = min(0.0, float(times.min()))
    t_hi = float(times.max()) + svc_b
    n_bins = max(8, min(n_bins, n))
    edges = np.linspace(t_lo, t_hi, n_bins + 1)
    dt = edges[1] - edges[0]
    arr = np.histogram(times, bins=edges)[0].astype(float)

    bounds = np.asarray(hist.bounds)
    counts = np.zeros(len(hist.counts))
    q = 0.0
    total_served = 0.0
    total_drop = 0.0
    total_busy = 0.0
    total_batches = 0.0
    total_lat = 0.0
    vmin, vmax = INF, -INF
    q_series = np.empty(n_bins)
    served_series = np.empty(n_bins)
    lat_series = np.empty(n_bins)
    for b in range(n_bins):
        supply = q + arr[b]
        served = min(mu * dt, supply)
        q_new = supply - served
        drop_b = max(0.0, q_new - cfg.queue_limit)
        q_new = min(q_new, float(cfg.queue_limit))
        q_mid = 0.5 * (q + q_new)
        rate = arr[b] / dt
        bhat = min(float(big_b),
                   max(1.0, rate * wnd, q_mid / max(k, 1)))
        wait = q_mid / mu + (0.5 * wnd if q_mid < big_b else 0.0)
        lat = wait + cost.service_time(bhat)
        if served > 0:
            counts[int(np.searchsorted(bounds, lat, side="left"))] \
                += served
            total_lat += served * lat
            vmin, vmax = min(vmin, lat), max(vmax, lat)
            total_busy += (served / bhat) * cost.service_time(bhat)
            total_batches += served / bhat
        q = q_new
        total_served += served
        total_drop += drop_b
        q_series[b] = q
        served_series[b] = served
        lat_series[b] = lat

    hist.counts = [int(round(c)) for c in counts]
    hist.n = int(round(total_served))
    hist.total = total_lat
    hist.vmin, hist.vmax = vmin, vmax
    stats = StreamingClusterStats(hist, int(round(total_served)),
                                  int(round(total_drop)),
                                  int(round(total_batches)), total_busy)
    if obs.enabled:
        m = obs.metrics
        m.counter("fleet.arrivals").inc(n)
        m.counter("fleet.drops").inc(stats.dropped)
        m.counter("fleet.batches").inc(stats.batches)
        m.counter("fleet.served").inc(stats.n_served)
        mid = edges[1:]
        for b in range(n_bins):
            tb = float(mid[b])
            m.record("fleet.arrival_rate_hz", tb, arr[b] / dt)
            m.record("fleet.queue_depth", tb, q_series[b])
            m.record("fleet.drop_fraction", tb,
                     1.0 - served_series[b] / arr[b] if arr[b] else 0.0)
            m.record("fleet.utilization", tb,
                     served_series[b] * svc_b / big_b / (k * dt))
            m.record("fleet.latency_p50_s", tb, lat_series[b])
            m.record("fleet.latency_p99_s", tb, lat_series[b])
        obs.tracer.add("cluster.fluid", t_lo, t_hi, clock="sim",
                       tid="cluster", cat="fleet",
                       args={"n": n, "bins": n_bins,
                             "dropped": stats.dropped})
    return stats


# ======================================================================
# windowed fleet.* reconstruction (the PR-6 series, from arrays)
# ======================================================================

def _emit_series(obs, window_s, ts, done_s, drop_s, bt, bn, cfg,
                 svc_lut, times_offer, tx_s, tx_bytes, disp_sorted_adm):
    """Reconstruct the windowed ``fleet.*`` time series of
    ``ClusterSim._sample_window`` from the result arrays.

    Same names, units, and window cadence; per-window latency quantiles
    go through the same streaming-histogram estimator.  Differences from
    the event sampler are documented in CONTRIBUTING: samples cover the
    whole run (the event chain stops at the last event), and the window
    width is widened when a run would exceed ``_MAX_WINDOWS`` samples.
    """
    m = obs.metrics
    n = len(ts)
    n_drop = int(drop_s.sum())
    m.counter("fleet.arrivals").inc(n)
    m.counter("fleet.drops").inc(n_drop)
    m.counter("fleet.batches").inc(len(bt))
    m.counter("fleet.served").inc(n - n_drop)

    t_end = float(ts[-1])
    if len(done_s) and (n - n_drop):
        t_end = max(t_end, float(done_s[~drop_s].max()))
    w = max(window_s, t_end / _MAX_WINDOWS if t_end > 0 else window_s)
    edges = np.arange(0.0, t_end + w, w)
    if len(edges) < 2:
        edges = np.array([0.0, w])
    t_samp = edges[1:]
    dt = np.diff(edges)

    arr_w = np.histogram(ts, bins=edges)[0]
    drop_w = np.histogram(ts[drop_s], bins=edges)[0]

    adm_t = ts[~drop_s]
    done_adm = done_s[~drop_s]
    # FIFO => dispatch times are non-decreasing in admission order
    depth = (np.searchsorted(adm_t, t_samp, side="right")
             - np.searchsorted(disp_sorted_adm, t_samp, side="right"))

    # utilization: service seconds attributed to the dispatch window
    svc_arr = svc_lut[bn] if len(bn) else np.empty(0)
    busy_w = np.histogram(bt, bins=edges, weights=svc_arr)[0]

    for name, vals in (("fleet.arrival_rate_hz", arr_w / dt),
                       ("fleet.queue_depth", depth.astype(float)),
                       ("fleet.drop_fraction",
                        np.divide(drop_w, arr_w,
                                  out=np.zeros(len(arr_w)),
                                  where=arr_w > 0)),
                       ("fleet.utilization",
                        busy_w / (cfg.n_replicas * dt))):
        for tb, v in zip(t_samp, vals):
            m.record(name, float(tb), float(v))

    # in-flight wire bytes at each sample instant
    if tx_s is not None and tx_bytes is not None:
        starts = np.asarray(times_offer, float) - np.asarray(tx_s, float)
        by = np.asarray(tx_bytes, float)
        so = np.argsort(starts, kind="stable")
        cum_start = np.concatenate(([0.0], np.cumsum(by[so])))
        ao = np.argsort(times_offer, kind="stable")
        cum_arr = np.concatenate(([0.0], np.cumsum(by[ao])))
        inflight = (cum_start[np.searchsorted(starts[so], t_samp,
                                              side="right")]
                    - cum_arr[np.searchsorted(
                        np.asarray(times_offer, float)[ao], t_samp,
                        side="right")])
    else:
        inflight = np.zeros(len(t_samp))
    for tb, v in zip(t_samp, inflight):
        m.record("fleet.inflight_bytes", float(tb), float(v))

    # per-window latency quantiles via the same streaming histogram
    lat = done_adm - adm_t
    order = np.argsort(done_adm, kind="stable")
    done_sorted = done_adm[order]
    lat_by_done = lat[order]
    cut = np.searchsorted(done_sorted, edges, side="right")
    hist = Histogram("fleet.window_latency_s")
    bounds = np.asarray(hist.bounds)
    for wi in range(len(t_samp)):
        seg = lat_by_done[cut[wi]:cut[wi + 1]]
        if not len(seg):
            continue
        idx = np.searchsorted(bounds, seg, side="left")
        hist.counts = np.bincount(
            idx, minlength=len(hist.counts)).tolist()
        hist.n = int(len(seg))
        hist.total = float(seg.sum())
        hist.vmin = float(seg.min())
        hist.vmax = float(seg.max())
        tb = float(t_samp[wi])
        m.record("fleet.latency_p50_s", tb, hist.percentile(50))
        m.record("fleet.latency_p99_s", tb, hist.percentile(99))
        hist.reset()

    obs.tracer.add("cluster.vectorized", 0.0, t_end, clock="sim",
                   tid="cluster", cat="fleet",
                   args={"n": n, "dropped": n_drop, "batches": len(bt)})


# ======================================================================
# ClusterSim-shaped wrapper
# ======================================================================

class VectorizedClusterSim:
    """Drop-in ``ClusterSim`` shape over the vectorized engine.

    Same constructor and ``offer`` / ``offer_trace`` / ``run`` surface,
    so planner code can swap engines behind one variable.  Offers are
    buffered as arrays; :meth:`run` simulates the whole horizon at once
    (``until`` must stay ``inf`` — partial-horizon replay is the event
    engine's job) and returns :class:`VectorClusterStats` (or
    :class:`StreamingClusterStats` with ``streaming=True``), cached on
    ``self.stats``.
    """

    def __init__(self, cost: BatchCostModel, cfg: ClusterConfig,
                 obs=None, window_s: Optional[float] = None,
                 streaming: bool = False):
        assert cfg.n_replicas >= 1 and cfg.max_batch >= 1
        self.cost, self.cfg = cost, cfg
        self.obs = NULL if obs is None else obs
        self.window_s = (window_s if window_s is not None
                         else self.obs.window_s)
        self.streaming = streaming
        self._rids: list = []
        self._times: list = []
        self._tx_s: list = []
        self._tx_bytes: list = []
        self._chunks: list = []      # (rids, times, tx_s, tx_bytes)
        self.stats = None

    # ------------------------------------------------------------ intake
    def offer(self, rid: int, t_arrival: float, *, tx_s: float = 0.0,
              tx_bytes: int = 0) -> None:
        self._rids.append(rid)
        self._times.append(t_arrival)
        self._tx_s.append(tx_s)
        self._tx_bytes.append(tx_bytes)

    def offer_trace(self, arrivals) -> None:
        """arrivals: iterable of ``(rid, t_arrival)`` or
        ``(rid, t_arrival, tx_s, tx_bytes)`` rows."""
        for row in arrivals:
            if len(row) == 2:
                self.offer(row[0], row[1])
            else:
                rid, t, tx_time, tx_b = row
                self.offer(rid, t, tx_s=tx_time, tx_bytes=tx_b)

    def offer_array(self, t_arrival, rids=None, tx_s=None,
                    tx_bytes=None) -> None:
        """Bulk intake: whole arrival arrays, no per-request python."""
        t_arrival = np.asarray(t_arrival, float)
        n = len(t_arrival)
        base = sum(len(c[1]) for c in self._chunks) + len(self._times)
        rids = (np.arange(base, base + n, dtype=np.int64)
                if rids is None else np.asarray(rids, np.int64))
        self._chunks.append((rids, t_arrival, tx_s, tx_bytes))

    # --------------------------------------------------------------- run
    def run(self, until: float = INF, mode: str = "exact",
            check_event_engine: bool = False):
        assert until == INF, \
            "vectorized engine runs whole horizons; use ClusterSim " \
            "for partial runs"
        rids, times, tx_s, tx_bytes = self._gather()
        self.stats = simulate_cluster_vectorized(
            times, self.cost, self.cfg, rids=rids, tx_s=tx_s,
            tx_bytes=tx_bytes, obs=self.obs, window_s=self.window_s,
            streaming=self.streaming, mode=mode,
            check_event_engine=check_event_engine)
        return self.stats

    def _gather(self):
        parts = list(self._chunks)
        if self._times:
            parts.append((np.asarray(self._rids, np.int64),
                          np.asarray(self._times, float),
                          np.asarray(self._tx_s, float),
                          np.asarray(self._tx_bytes, float)))
        if not parts:
            return (np.empty(0, np.int64), np.empty(0),
                    None, None)
        rids = np.concatenate([p[0] for p in parts])
        times = np.concatenate([p[1] for p in parts])
        have_tx = any(p[2] is not None and np.any(np.asarray(p[2]))
                      for p in parts)
        if have_tx:
            tx_s = np.concatenate(
                [np.zeros(len(p[1])) if p[2] is None
                 else np.broadcast_to(np.asarray(p[2], float),
                                      (len(p[1]),)).copy()
                 for p in parts])
            tx_bytes = np.concatenate(
                [np.zeros(len(p[1])) if p[3] is None
                 else np.broadcast_to(np.asarray(p[3], float),
                                      (len(p[1]),)).copy()
                 for p in parts])
        else:
            tx_s = tx_bytes = None
        return rids, times, tx_s, tx_bytes
