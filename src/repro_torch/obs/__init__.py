"""HAIL flight recorder: metrics registry, span tracing, per-query EXPLAIN.

* ``obs.metrics`` — the unified ``MetricsRegistry`` (counters / gauges /
  histograms with labels, snapshot/delta semantics, collectors sampling
  the kernel dispatch counters and per-store state).
* ``obs.trace`` — structured span tracing on measured + simulated clocks
  with a Chrome trace-event (Perfetto) exporter and validator; zero-cost
  when no tracer is installed.
* ``obs.explain`` — ``Ticket.explain()``: the per-query latency
  decomposition (queue wait vs service, scan modes, cache-tier outcome,
  build/demote walls charged), exact against the modeled schedule.
"""
from repro_torch.obs import explain, metrics, trace  # noqa: F401
from repro_torch.obs.metrics import (REGISTRY, MetricsRegistry,  # noqa: F401
                                     nearest_rank, observe_flush,
                                     observe_job, observe_upload,
                                     register_store)
from repro_torch.obs.trace import (Tracer, install, uninstall,  # noqa: F401
                                   validate_chrome_trace)
