"""Live ``/metrics`` exporter: Prometheus text exposition of the metrics
registry over a standard-library HTTP server (ref:
``paddle_tpu/observability/exporter.py``).

    srv = start_metrics_server(9090)     # 0 (the default) = off
    ...
    srv.stop()

Rendering: names take the Prometheus charset ('.' -> '_') and the HELP
line carries the registry name; counters and gauges export per label
set; histograms export as summaries (quantiles 0.5, 0.9 and 0.99 over the
reservoir, plus ``_count`` and ``_sum``); label values escape backslash,
double quote and newline; a registered metric with no samples still
emits HELP and TYPE. ``/healthz`` answers ``ok``.
"""

import http.server
import re
import threading

from paddle_tpu_torch.observability import catalog as _catalog
from paddle_tpu_torch.observability import metrics as _metrics

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", 0.50), ("0.9", 0.90), ("0.99", 0.99))


def prom_name(name):
    """Registry name -> Prometheus metric name."""
    out = _NAME_BAD.sub("_", str(name))
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def escape_label_value(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text):
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v):
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels, extra=()):
    parts = [f'{prom_name(k)}="{escape_label_value(v)}"'
             for k, v in list(extra) + sorted(labels.items())]
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(registry=None):
    """The whole registry as Prometheus text exposition."""
    reg = registry if registry is not None else _metrics.registry()
    lines = []
    for name in reg.names():
        m = reg.get(name)
        if m is None:
            continue
        pname = prom_name(name)
        help_txt = _catalog.help_for(name) or m.help or ""
        lines.append(f"# HELP {pname} "
                     f"{_escape_help(f'{name} {help_txt}'.strip())}")
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "summary"}[m.kind]
        lines.append(f"# TYPE {pname} {ptype}")
        snap = m.snapshot()
        for key in sorted(snap):
            labels = _metrics.parse_label_key(key)
            if m.kind in ("counter", "gauge"):
                lines.append(
                    f"{pname}{_label_str(labels)} {_fmt_value(snap[key])}")
            else:
                st = snap[key]
                for qname, q in _QUANTILES:
                    v = m.percentile(q, **labels)
                    if v is None:
                        continue
                    lines.append(
                        f"{pname}{_label_str(labels, [('quantile', qname)])}"
                        f" {_fmt_value(v)}")
                lines.append(f"{pname}_count{_label_str(labels)} "
                             f"{_fmt_value(st['count'])}")
                lines.append(f"{pname}_sum{_label_str(labels)} "
                             f"{_fmt_value(st['sum'])}")
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(self.server.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body, ctype = b"ok\n", "text/plain; charset=utf-8"
        else:
            self.send_error(404)
            return
        self.server.registry.counter(
            "exporter.scrapes",
            _catalog.help_for("exporter.scrapes")).inc(path=path)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):    # scrapes must not spam stdout
        pass


class MetricsServer:
    """``/metrics`` and ``/healthz`` over one MetricsRegistry, served
    from a daemon thread. ``port`` is the literal bind port (0: one the
    OS assigns; read ``.port`` after ``start()``)."""

    def __init__(self, port=0, registry=None, host="0.0.0.0"):
        self._bind = (host, int(port))
        self.registry = (registry if registry is not None
                         else _metrics.registry())
        self._lock = threading.Lock()    # start()/stop() only
        self._httpd = None
        self._thread = None

    @property
    def port(self):
        with self._lock:
            return (self._httpd.server_address[1]
                    if self._httpd else None)

    def start(self):
        with self._lock:
            if self._httpd is not None:
                return self
            httpd = http.server.ThreadingHTTPServer(self._bind, _Handler)
            httpd.daemon_threads = True
            httpd.registry = self.registry
            self._httpd = httpd
            self._thread = threading.Thread(
                target=httpd.serve_forever, name="metrics-exporter",
                daemon=True)
            self._thread.start()
            return self

    def stop(self):
        with self._lock:
            if self._httpd is None:
                return
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def start_metrics_server(port=0, registry=None):
    """Start the exporter on ``port``; 0 or None (the ``metrics_port``
    flag's default) means off and returns None."""
    port = int(port or 0)
    if port == 0:
        return None
    return MetricsServer(port=port, registry=registry).start()
