"""Unified metrics registry: typed counters/gauges/histograms with labels.

The port's copy of the JAX package's ``obs/metrics.py`` (which is
framework-free), with its collector pointed at this package's kernel layer.
It makes four surfaces — ``ops.reader_stats`` counters,
``JobStats``/``FlushStats``, the governor's ``AccessLog`` and the
scrubber's ``ScrubStats`` — one self-describing surface:

* **Instruments**: ``Counter`` (monotone), ``Gauge`` (sampled level) and
  ``Histogram`` (count/sum/min/max + nearest-rank percentiles), each keyed
  by name + a label set (tenant, column, replica, scan-mode, cache-tier —
  whatever the call site knows).
* **Collectors**: pull adapters registered on the registry and run at
  ``snapshot()`` time.  The reader-stats collector (installed on the
  default ``REGISTRY`` at import) samples every ``ops.DISPATCH_COUNTS`` /
  ``TRACE_COUNTS`` key — per-column attribution like
  ``index_scan_blocks[visitDate]`` becomes a ``column`` label —  so a
  registry snapshot always reflects the live kernel counters.
  ``register_store`` adds governor heat, demotion totals, cache tiers and
  the scrubber cursor for one store.
* **Snapshot/delta**: ``snapshot()`` returns a flat ``{series: value}``
  dict; ``delta(before)`` subtracts two snapshots (what the replication
  controller reads its heat from).
* **Observers**: ``observe_job`` / ``observe_flush`` / ``observe_upload``
  fold the existing stats dataclasses into first-class instruments (walls
  into histograms, counts into counters) — called by ``run_job``,
  ``HailServer.flush`` and the upload pipelines.

``nearest_rank`` is the pinned percentile semantics shared with
``ServerFrontend.percentile_latency`` (see its doctest).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional


def nearest_rank(values, p: float) -> float:
    """Nearest-rank percentile: the smallest element with at least
    ``p``% of the sample at or below it — ``sorted[ceil(p/100*N)] - 1``
    (1-indexed), never interpolated, so small-N guards are not sensitive
    to interpolation off-by-ones and every returned value is an actually
    observed sample.

    >>> nearest_rank([10.0, 20.0, 30.0, 40.0], 50)
    20.0
    >>> nearest_rank([10.0, 20.0, 30.0, 40.0], 99)
    40.0
    >>> nearest_rank([40.0, 10.0, 30.0, 20.0], 25)
    10.0
    >>> nearest_rank([7.5], 1)
    7.5
    >>> nearest_rank([1.0, 2.0], 0)
    1.0
    """
    vals = sorted(values)
    if not vals:
        raise ValueError("nearest_rank of an empty sample")
    k = max(1, math.ceil(float(p) / 100.0 * len(vals)))
    return float(vals[min(k, len(vals)) - 1])


def _series(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Instrument:
    __slots__ = ("name", "labels", "series")
    kind = "instrument"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = dict(labels)
        self.series = _series(name, labels)


class Counter(Instrument):
    """Monotone count — ``inc`` only."""
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, value: float = 1.0):
        if value < 0:
            raise ValueError(f"counter {self.series}: negative inc {value}")
        self.value += value


class Gauge(Instrument):
    """Sampled level — ``set`` replaces; collectors use these to mirror
    externally-owned counters (delta semantics still work because the
    snapshot samples the source each time)."""
    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)


class Histogram(Instrument):
    """Distribution: count/sum/min/max plus nearest-rank percentiles over
    the retained samples (these are simulation-scale series — retention is
    exact, not sketched)."""
    __slots__ = ("count", "total", "vmin", "vmax", "samples")
    kind = "histogram"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: list[float] = []

    def observe(self, value: float):
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.samples.append(v)

    def percentile(self, p: float) -> float:
        return nearest_rank(self.samples, p)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Instrument store + collector runner with snapshot/delta semantics."""

    def __init__(self):
        self._instruments: dict[str, Instrument] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []

    # -- instrument access (get-or-create; kind clashes are bugs) -----------

    def _get(self, cls, name: str, labels: dict):
        key = _series(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = cls(name, labels)
        elif not isinstance(inst, cls):
            raise TypeError(f"{key} already registered as {inst.kind}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def inc(self, name: str, value: float = 1.0, **labels):
        self.counter(name, **labels).inc(value)

    def observe(self, name: str, value: float, **labels):
        self.histogram(name, **labels).observe(value)

    def get(self, series: str) -> Optional[Instrument]:
        return self._instruments.get(series)

    def instruments(self) -> list[Instrument]:
        return list(self._instruments.values())

    # -- collectors ---------------------------------------------------------

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]):
        self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn):
        self._collectors = [c for c in self._collectors if c is not fn]

    def collect(self):
        for fn in list(self._collectors):
            fn(self)

    # -- snapshot / delta ---------------------------------------------------

    def snapshot(self, collect: bool = True) -> dict[str, float]:
        """Flat ``{series: value}``; histograms expand to ``.count``,
        ``.sum``, ``.min``, ``.max`` series."""
        if collect:
            self.collect()
        out: dict[str, float] = {}
        for inst in self._instruments.values():
            if isinstance(inst, Histogram):
                out[_series(inst.name + ".count", inst.labels)] = \
                    float(inst.count)
                out[_series(inst.name + ".sum", inst.labels)] = inst.total
                if inst.count:
                    out[_series(inst.name + ".min", inst.labels)] = inst.vmin
                    out[_series(inst.name + ".max", inst.labels)] = inst.vmax
            else:
                out[inst.series] = inst.value
        return out

    def delta(self, before: dict[str, float],
              after: Optional[dict[str, float]] = None,
              collect: bool = True) -> dict[str, float]:
        """``after - before`` per series (``after`` defaults to a fresh
        snapshot); series absent from ``before`` diff against 0."""
        if after is None:
            after = self.snapshot(collect=collect)
        return {k: v - before.get(k, 0.0) for k, v in after.items()}

    def reset(self):
        self._instruments.clear()


REGISTRY = MetricsRegistry()


def snapshot(collect: bool = True) -> dict[str, float]:
    return REGISTRY.snapshot(collect=collect)


def delta(before: dict[str, float], **kw) -> dict[str, float]:
    return REGISTRY.delta(before, **kw)


# ---------------------------------------------------------------------------
# collectors: reader-stats counters and per-store state
# ---------------------------------------------------------------------------

_READER_KEY = re.compile(r"^(?P<name>[^\[\]]+)(?:\[(?P<column>[^\]]+)\])?$")


def parse_reader_key(key: str) -> tuple[str, dict]:
    """``index_scan_blocks[visitDate]`` -> (``index_scan_blocks``,
    ``{"column": "visitDate"}``); plain keys get no labels."""
    m = _READER_KEY.match(key)
    if m is None or m.group("column") is None:
        return key, {}
    return m.group("name"), {"column": m.group("column")}


def reader_stats_collector(reg: MetricsRegistry):
    """Sample every live ``ops`` dispatch/trace counter into the registry
    (gauges, so ``reset_stats``/``stats_scope`` swaps stay coherent —
    a snapshot always mirrors the innermost scope's counters, and a
    counter that vanished from the source reads 0, never a stale value)."""
    from repro_torch.kernels import ops
    stats = ops.reader_stats()
    seen: set[str] = set()
    for key, v in stats["dispatches"].items():
        name, labels = parse_reader_key(key)
        g = reg.gauge(f"reader.{name}", **labels)
        g.set(v)
        seen.add(g.series)
    for key, v in stats["traces"].items():
        g = reg.gauge(f"reader.traces.{key}")
        g.set(v)
        seen.add(g.series)
    for inst in reg.instruments():
        if (isinstance(inst, Gauge) and inst.series not in seen
                and inst.name.startswith("reader.")):
            inst.set(0.0)


REGISTRY.register_collector(reader_stats_collector)


def register_store(store, registry: Optional[MetricsRegistry] = None):
    """Register a per-store collector: governor heat/demotions, both cache
    tiers and the scrubber cursor become sampled gauges.  Returns the
    collector (pass to ``unregister_collector`` when the store is done)."""
    reg = registry if registry is not None else REGISTRY

    def _collect(r: MetricsRegistry):
        log = store.access_log
        if log is not None:
            for (rid, col), rec in log.counts.items():
                r.gauge("governor.heat", replica=rid, column=col).set(
                    rec.hits + rec.misses)
                r.gauge("governor.miss_heat", replica=rid, column=col).set(
                    rec.misses)
                r.gauge("governor.last_used", replica=rid, column=col).set(
                    rec.last_used)
            r.gauge("governor.job_clock").set(log.job_clock)
        gov = store.governor
        if gov is not None:
            r.gauge("governor.blocks_demoted").set(gov.blocks_demoted_total)
            r.gauge("governor.demotions").set(len(gov.events))
        if store.block_cache is not None:
            st = store.block_cache.stats
            r.gauge("cache.hits", tier="block").set(st.hits)
            r.gauge("cache.misses", tier="block").set(st.misses)
            r.gauge("cache.evictions", tier="block").set(st.evictions)
            # (the JAX package reads a ``resident_bytes`` field CacheStats
            # does not have, so its snapshot raises while a block cache is
            # attached; the field is ``bytes_cached``)
            r.gauge("cache.resident_bytes", tier="block").set(
                st.bytes_cached)
        if store.result_cache is not None:
            st = store.result_cache.stats
            r.gauge("cache.hits", tier="result").set(st.hits)
            r.gauge("cache.misses", tier="result").set(st.misses)
        if store.scrubber is not None:
            sc = store.scrubber
            r.gauge("scrubber.cursor").set(sc._cursor)
            r.gauge("scrubber.ticks").set(sc.stats.ticks)
            r.gauge("scrubber.blocks_verified").set(sc.stats.blocks_verified)
            r.gauge("scrubber.blocks_repaired").set(sc.stats.blocks_repaired)
        r.gauge("store.version").set(store.version)
        r.gauge("store.total_indexed_blocks").set(
            store.total_indexed_blocks() if store.layout == "pax" else 0)
        if store.layout == "pax":
            r.gauge("store.live_replicas").set(len(store.live_replica_ids()))

    reg.register_collector(_collect)
    return _collect


# ---------------------------------------------------------------------------
# observers: fold the existing stats dataclasses into instruments
# ---------------------------------------------------------------------------


def observe_job(stats, registry: Optional[MetricsRegistry] = None, **labels):
    """Fold one ``JobStats`` into the registry (called by ``run_job``)."""
    reg = registry if registry is not None else REGISTRY
    reg.inc("job.jobs", 1, **labels)
    reg.inc("job.tasks", stats.n_tasks, **labels)
    reg.inc("job.bytes_read", stats.bytes_read, **labels)
    reg.inc("job.blocks_indexed", stats.blocks_indexed, **labels)
    reg.inc("job.blocks_demoted", stats.blocks_demoted, **labels)
    reg.inc("job.blocks_quarantined", stats.blocks_quarantined, **labels)
    reg.inc("job.corrupt_retries", stats.corrupt_retries, **labels)
    reg.inc("job.rescheduled_tasks", stats.rescheduled_tasks, **labels)
    reg.inc("job.blocks", stats.full_scan_blocks,
            scan_mode="full", **labels)
    reg.observe("job.wall_s", stats.map_compute_s, **labels)
    reg.observe("job.modeled_s", stats.modeled_s, **labels)
    reg.observe("job.build_s", stats.index_build_s, **labels)
    reg.observe("job.rekey_s", stats.rekey_s, **labels)
    reg.observe("job.scrub_s", stats.scrub_s, **labels)
    for s in stats.split_s:
        reg.observe("job.split_s", s, **labels)


def observe_flush(stats, registry: Optional[MetricsRegistry] = None,
                  tenants=(), **labels):
    """Fold one ``FlushStats`` into the registry (called by ``flush``).
    ``tenants``: the flush's tickets' tenants, counted per label."""
    reg = registry if registry is not None else REGISTRY
    reg.inc("flush.flushes", 1, **labels)
    reg.inc("flush.queries", stats.n_queries, **labels)
    reg.inc("flush.batches", stats.n_batches, **labels)
    reg.inc("flush.splits", stats.n_splits, **labels)
    reg.inc("flush.bytes_read", stats.bytes_read, **labels)
    reg.inc("flush.blocks_indexed", stats.blocks_indexed, **labels)
    reg.inc("flush.blocks_demoted", stats.blocks_demoted, **labels)
    reg.inc("flush.blocks_quarantined", stats.blocks_quarantined, **labels)
    reg.inc("flush.corrupt_retries", stats.corrupt_retries, **labels)
    reg.inc("flush.failed_queries", len(stats.failed_queries), **labels)
    reg.inc("flush.cache_hits", stats.cache_hits, tier="block", **labels)
    reg.inc("flush.cache_misses", stats.cache_misses, tier="block", **labels)
    reg.inc("flush.cache_hits", stats.result_cache_hits,
            tier="result", **labels)
    reg.inc("flush.cache_misses", stats.result_cache_misses,
            tier="result", **labels)
    for tenant in tenants:
        reg.inc("flush.tenant_queries", 1, tenant=tenant, **labels)
    reg.observe("flush.wall_s", stats.wall_s, **labels)
    reg.observe("flush.modeled_s", stats.modeled_s, **labels)
    reg.observe("flush.scrub_s", stats.scrub_s, **labels)
    for s in stats.split_s:
        reg.observe("flush.split_s", s, **labels)
    for done in stats.query_done_s.values():
        reg.observe("flush.query_done_s", done, **labels)


def observe_upload(kind: str, stats,
                   registry: Optional[MetricsRegistry] = None):
    """Fold one ``UploadStats`` into the registry (upload pipelines)."""
    reg = registry if registry is not None else REGISTRY
    reg.inc("upload.uploads", 1, kind=kind)
    reg.inc("upload.ascii_bytes", stats.ascii_bytes, kind=kind)
    reg.inc("upload.written_bytes", stats.written_bytes, kind=kind)
    reg.inc("upload.extra_read_bytes", stats.extra_read_bytes, kind=kind)
    reg.inc("upload.n_indexes", stats.n_indexes, kind=kind)
    reg.observe("upload.wall_s", stats.wall_s, kind=kind)
    for phase, wall in stats.phases.items():
        reg.observe("upload.phase_s", wall, kind=kind, phase=phase)
