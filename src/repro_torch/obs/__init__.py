"""HAIL flight recorder: metrics registry and span tracing.

* ``obs.metrics`` — the unified ``MetricsRegistry`` (counters / gauges /
  histograms with labels, snapshot/delta semantics, collectors sampling
  the kernel dispatch counters and per-store state).
* ``obs.trace`` — structured span tracing on measured + simulated clocks
  with a Chrome trace-event (Perfetto) exporter and validator; zero-cost
  when no tracer is installed.
"""
from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import (REGISTRY, MetricsRegistry,  # noqa: F401
                                     nearest_rank, observe_job,
                                     observe_upload, register_store)
from repro_torch.obs.trace import (Tracer, install, uninstall,  # noqa: F401
                                   validate_chrome_trace)
