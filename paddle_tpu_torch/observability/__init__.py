"""Observability of the port (``paddle_tpu/observability``): the metrics
registry (``metrics``) and its catalog of names and help text
(``catalog``), the JSONL run log (``runlog``), the ``/metrics`` exporter
(``exporter``), the anomaly watchdog (``watchdog``), fleet trace
contexts and the cross-replica merge (``trace``), the flight recorder
(``flight``), nestable spans (``spans``), the Trainer's step telemetry
(``telemetry``) and the card's MFU and memory arithmetic (``perf``).

The span, telemetry and perf names below load on first use, so that
``core/retry.py`` can import ``metrics`` without pulling the rest in:

    from paddle_tpu_torch import observability as obs
    with obs.span("step"):
        ...
    print(obs.span_report())
"""

import importlib

_LAZY = {
    "span": "spans", "annotate_span": "spans", "span_summary": "spans",
    "span_report": "spans", "reset_spans": "spans", "recorder": "spans",
    "TelemetryConfig": "telemetry", "StepTelemetry": "telemetry",
    "default_tokens": "telemetry",
    "peak_flops": "perf", "cost_flops": "perf", "mfu": "perf",
    "device_memory_stats": "perf",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
