"""Unified serving telemetry — public import surface.

The implementation lives in ``repro_torch.core.telemetry`` so that
``repro_torch.core.context`` (which the serving engines import) can use the
same registry/tracer without a package-import cycle through
``repro_torch.serve.__init__``.  Import from here in serving code::

    from repro_torch.serve.telemetry import Telemetry, Tracer, safe_ratio

See docs/observability.md (written for the JAX package, whose metric
names this package keeps) for the metric glossary and span taxonomy.
"""
from repro_torch.core.telemetry import (LATENCY_BUCKETS_S, Histogram,
                                        ManualClock, MetricRegistry,
                                        MetricView, Telemetry, Tracer,
                                        safe_ratio)

__all__ = ["LATENCY_BUCKETS_S", "Histogram", "ManualClock", "MetricRegistry",
           "MetricView", "Telemetry", "Tracer", "safe_ratio"]
