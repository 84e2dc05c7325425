"""Telemetry plane: span tracing, idle attribution, metrics registry.

Pure Python, no third-party deps, the same pieces as the JAX package's
``obs`` (whose exports these are):

* :mod:`repro_torch.obs.trace` — span/instant tracing on a detached seam
  (one module-flag read per site when off), with Chrome trace-event JSON
  export (Perfetto / chrome://tracing).
* :mod:`repro_torch.obs.idle` — per-lane gap classification into the
  paper's two idle classes (task-dependency vs straggler) plus
  pipeline-fill warmup, from a captured trace.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms behind one :class:`MetricsRegistry`.
* :mod:`repro_torch.obs.clock` — the one wall-clock (``now()``) for
  instrumented hot paths.
"""
from .clock import now  # noqa: F401
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .trace import (Tracer, attach, detach, emit_instant,  # noqa: F401
                    emit_span, span, traced, validate_chrome_trace)
from .idle import attribute_idle  # noqa: F401
