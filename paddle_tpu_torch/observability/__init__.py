"""Observability of the port (``paddle_tpu/observability``), standard
library only: the metrics registry (``metrics``) and its catalog of names
and help text (``catalog``), the JSONL run log (``runlog``), the
``/metrics`` exporter (``exporter``), the anomaly watchdog
(``watchdog``), fleet trace contexts and the cross-replica merge
(``trace``) and the flight recorder (``flight``). Spans, step telemetry
and the performance arithmetic are not ported."""
