"""Observability of the port (``paddle_tpu/observability``): the metrics
registry (``metrics``) and the JSONL run log (``runlog``), both standard
library only. The HTTP exporter, the flight recorder, traces, spans and
the watchdog are not ported."""
