"""Metric catalog: the name, kind, labels and help text of every metric
the framework emits (ref: ``paddle_tpu/observability/catalog.py``,
standard library only, kept as the port's own copy with the reference's
names and help text). Names ending in '.' are prefixes of dynamically
composed families (span.<path>).

The exporter's HELP lines read ``help_for``; the serving engine and the
fleet router ``preregister`` their families so ``/metrics`` lists them
before any traffic.
"""

import collections

MetricSpec = collections.namedtuple("MetricSpec", ["kind", "labels", "help"])

# name -> (kind, label names, help). Keep alphabetized within each group.
CATALOG = {
    # parallel/autoplan/search.py
    "autoplan.candidates": MetricSpec(
        "counter", ("outcome",),
        "Mesh factorizations considered by the auto-parallelism search, "
        "by outcome (scored vs pruned-with-reason)."),
    "autoplan.plan_s": MetricSpec(
        "histogram", (),
        "Wall time of one autoplan search (enumerate + price + rank)."),
    # ops/pallas/autotune.py
    "autotune.cache": MetricSpec(
        "counter", ("event",),
        "Autotune tile-cache lookups by event (hit | miss | corrupt)."),
    "autotune.sweeps": MetricSpec(
        "counter", ("kernel",),
        "Tile-shape sweeps run by the Pallas autotuner (first eager "
        "contact with a kernel/shape/chip triple)."),
    # amp.py (published host-side by the guardian's ScalerObserver bridge)
    "amp.loss_scale": MetricSpec(
        "gauge", (), "Current dynamic loss scale of the amp.LossScaler."),
    "amp.skipped_steps": MetricSpec(
        "counter", (),
        "Optimizer updates the loss scaler skipped on non-finite "
        "gradients (delta-published from the scaler state's cumulative "
        "skip count)."),
    # bench.py
    "bench.step_time_s": MetricSpec(
        "histogram", (), "Per-step wall time of a timed bench window."),
    # io/checkpoint.py
    "checkpoint.corrupt_leaves": MetricSpec(
        "counter", (),
        "Restored checkpoint leaves whose crc32 disagreed with the "
        "step's integrity manifest."),
    "checkpoint.integrity_fallbacks": MetricSpec(
        "counter", (),
        "Checkpoint steps abandoned at restore (corrupt or unreadable "
        "even after a mirror re-fetch), degrading to the previous "
        "committed step."),
    "checkpoint.mirror_degraded": MetricSpec(
        "counter", (),
        "Checkpoint mirror pushes that failed after retries and degraded "
        "to queue-and-continue."),
    "checkpoint.restores": MetricSpec(
        "counter", (), "Checkpoint restores served."),
    "checkpoint.saves": MetricSpec(
        "counter", (), "Checkpoint saves committed."),
    "checkpoint.torn_skips": MetricSpec(
        "counter", (),
        "Uncommitted (torn) checkpoint steps skipped at discovery."),
    # parallel/communicator.py
    "collective.quant_bytes": MetricSpec(
        "counter", ("direction",),
        "Bytes the quantized dp all-reduce moved on the wire (int8 "
        "payload plus per-chunk scales), by direction (send | recv) — "
        "compare against grad elements x 4 for the f32 baseline."),
    "collective.quant_degraded": MetricSpec(
        "counter", (),
        "Gradient syncs that degraded from the quantized int8 "
        "all-reduce to plain f32 psum (the collective.quant fault "
        "point, or guardian-driven parity fallback)."),
    # tools/graft_lint.py
    "contracts.violations": MetricSpec(
        "counter", ("contract",),
        "Compile-contract violations reported by a graft-lint "
        "--contracts run, by CONTRACTS row name."),
    # observability/exporter.py
    "exporter.scrapes": MetricSpec(
        "counter", ("path",),
        "HTTP requests served by the /metrics exporter."),
    # serving/fleet.py
    "fleet.affinity_hits": MetricSpec(
        "counter", (),
        "Dispatches routed by prefix affinity — the chosen replica's "
        "prefix cache already held the request's leading prompt pages "
        "(least-loaded remains the tiebreak and the imbalance "
        "fallback)."),
    "fleet.canary_aborts": MetricSpec(
        "counter", (),
        "Automatic canary aborts: the canary version's goodput fell "
        "below the baseline's by more than the configured margin, so "
        "canary routing stopped and its replicas rolled back."),
    "fleet.deploys": MetricSpec(
        "counter", ("status",),
        "FleetRouter.deploy() outcomes: ok (baseline moved), canary "
        "(one replica swapped, weighted routing started), rejected "
        "(fleet draining), aborted (corrupt manifest or failed first "
        "swap; fleet untouched), rolled_back (mid-rollout failure; "
        "already-swapped replicas restored)."),
    "fleet.dispatch_depth": MetricSpec(
        "gauge", ("replica",),
        "Requests dispatched to a replica and not yet terminal, by "
        "replica index — the single /metrics endpoint's per-replica "
        "aggregation label."),
    "fleet.handoffs": MetricSpec(
        "counter", (),
        "Prefill->decode disaggregation handoffs: a prefill-role "
        "replica finished a request's chunked prefill plus first "
        "token and the router re-dispatched the remainder to a "
        "decode replica via the token-exact adopt() replay path."),
    "fleet.failovers": MetricSpec(
        "counter", (),
        "Replica deaths handled by the fleet router (step crash past "
        "the engine budget, killed process, heartbeat loss); each one "
        "re-routes in-flight work and respawns the replica."),
    "fleet.replicas": MetricSpec(
        "gauge", ("state",),
        "Fleet replicas by state (live | stalled | draining | dead | "
        "retired — retired = permanently removed by a scale-down)."),
    "fleet.rerouted": MetricSpec(
        "counter", (),
        "In-flight requests re-routed to a healthy replica after a "
        "replica death (token-exact failover replay)."),
    "fleet.respawns": MetricSpec(
        "counter", ("replica",),
        "Replica respawns performed under the fleet RetryBudget."),
    "fleet.scale_events": MetricSpec(
        "counter", ("direction",),
        "Fleet autoscaling actions: up = a replica spawned against "
        "pending backlog, down = a replica gracefully drained and "
        "retired against sustained slack."),
    "fleet.version_retirements": MetricSpec(
        "counter", ("version",),
        "Fleet request retirements by the model version that served "
        "(or was routed for) the request — the per-version SLO plane "
        "the canary comparison reads."),
    # observability/flight.py
    "flight.dumps": MetricSpec(
        "counter", ("status",),
        "Flight-recorder bundle dumps by outcome (ok = a complete "
        "bundle landed, error = the dump failed or was fault-injected "
        "and was swallowed — anomaly handlers never raise)."),
    # parallel/heartbeat.py
    "heartbeat.barrier_wait_s": MetricSpec(
        "counter", ("barrier",),
        "Wall seconds spent waiting in heartbeat barriers."),
    "heartbeat.missed": MetricSpec(
        "counter", ("worker",),
        "Peers declared stalled by a heartbeat monitor (latched once per "
        "stall)."),
    # jit trace accounting (serving/engine.py + observability/watchdog.py)
    "jit.retraces": MetricSpec(
        "counter", ("fn",),
        "Traces beyond the first of a function the runtime asserts is "
        "traced once (serve decode/prefill, the Trainer step)."),
    # tools/graft_lint.py
    "lint.findings": MetricSpec(
        "counter", ("rule",),
        "Findings reported by a graft-lint run, by rule name — scraped "
        "from CI runs to trend which detectors fire."),
    # ops/pallas
    "pallas.fallback": MetricSpec(
        "counter", ("kernel",),
        "Pallas kernel refusals that fell back to the XLA formulation."),
    # parallel/communicator.py
    "quant.overflow_clamps": MetricSpec(
        "counter", (),
        "Gradient values the quantized all-reduce clamped at the int8 "
        "rail (|round(x/scale)| > 127). Zero in healthy operation — the "
        "shared absmax scale covers every rank's range; non-zero flags "
        "non-finite or scale-corrupting gradients for the guardian."),
    # core/retry.py
    "retry.attempts": MetricSpec(
        "counter", ("op",), "Retried attempts of remote I/O operations."),
    "retry.giveups": MetricSpec(
        "counter", ("op",),
        "Remote I/O operations that exhausted their retry budget."),
    # serving/engine.py
    "serve.active_slots": MetricSpec(
        "gauge", (), "Decode slots holding a live request."),
    "serve.cow_copies": MetricSpec(
        "counter", (),
        "Copy-on-write divergences: a prefix-cache-shared page "
        "duplicated to a private page before a slot's first write "
        "into it."),
    "serve.goodput": MetricSpec(
        "gauge", (),
        "Fraction of retired requests that met every configured SLO "
        "(slo_ttft_s / slo_token_latency_s)."),
    "serve.kv_quant_degraded": MetricSpec(
        "counter", (),
        "Quantized-KV admissions degraded to private pages by the "
        "quant.kv_write fault point (no prefix-cache mapping or "
        "publish for that request)."),
    "serve.kv_quant_pages": MetricSpec(
        "gauge", (),
        "KV pages currently allocated out of an int8-quantized page "
        "pool (0 / absent when serve_kv_dtype is f32)."),
    "serve.page_stalls": MetricSpec(
        "counter", ("where",),
        "Admissions or decode growths that waited on a free KV page."),
    "serve.pages_shared": MetricSpec(
        "gauge", (),
        "Prefix-cache pages currently mapped read-only by at least one "
        "slot."),
    "serve.preemptions": MetricSpec(
        "counter", (),
        "Requests preempted (pages freed, requeued) on pool deadlock."),
    "serve.prefix_hits": MetricSpec(
        "counter", (),
        "Full prompt pages served read-only from the prefix cache at "
        "admission — prefill for those tokens is skipped entirely."),
    "serve.prefix_misses": MetricSpec(
        "counter", (),
        "Full prompt pages that missed the prefix cache at admission "
        "and were prefilled into private pages."),
    "serve.queue_depth": MetricSpec(
        "gauge", (), "Requests waiting for a decode slot."),
    "serve.recoveries": MetricSpec(
        "counter", ("where",),
        "Serve-step failures recovered by quarantining device state and "
        "re-admitting in-flight requests (where: serve.prefill | "
        "serve.step)."),
    "serve.requests": MetricSpec(
        "counter", ("status",),
        "Request lifecycle tallies (status: submitted | adopted | "
        "completed | rejected | shed | cancelled | failed; adopted = "
        "fleet dispatch / failover replay into an engine)."),
    "serve.shed": MetricSpec(
        "counter", ("cause",),
        "Queued requests shed by deadline expiry or watchdog-driven "
        "load shedding (cause: deadline | goodput_collapse | "
        "ingest_stall)."),
    "serve.spec_accepted": MetricSpec(
        "counter", (),
        "Draft proposals the speculative verify step accepted (the "
        "leading run where the draft token equals the target's own "
        "per-position sample); acceptance_rate = spec_accepted / "
        "spec_proposed."),
    "serve.spec_proposed": MetricSpec(
        "counter", (),
        "Draft tokens proposed to the speculative verify step (up to "
        "serve_spec_k per active slot per round, clamped by each "
        "slot's page/window budget)."),
    "serve.spec_rollbacks": MetricSpec(
        "counter", (),
        "Draft proposals rejected by the verify step and rolled back "
        "(a host-side length edit — stale KV beyond the accepted "
        "prefix is overwritten by later writes)."),
    "serve.slo_violations": MetricSpec(
        "counter", ("kind",),
        "Retired requests that missed an SLO (kind: ttft | "
        "token_latency)."),
    "serve.token_latency_s": MetricSpec(
        "histogram", (), "Per-token decode-step latency."),
    "serve.tokens": MetricSpec(
        "counter", (), "Tokens emitted by the serving engine."),
    "serve.ttft_s": MetricSpec(
        "histogram", (), "Time from submit() to a request's first token."),
    # observability/spans.py (dynamic family: span.<path>)
    "span.": MetricSpec(
        "histogram", (), "Host-side span timings (spans.span scopes)."),
    # static/trainer.py + observability/telemetry.py
    "trainer.channel_depth": MetricSpec(
        "gauge", (), "Ingest channel occupancy sampled at each dequeue."),
    "trainer.ingest_errors": MetricSpec(
        "counter", ("reason",),
        "Ingest reader threads that died, by exception type."),
    "trainer.ingest_stall_s": MetricSpec(
        "counter", (),
        "Wall time the device loop spent blocked on the ingest channel."),
    "trainer.loss_spikes": MetricSpec(
        "counter", (),
        "Loss-spike episodes latched by the training guardian (a finite "
        "loss above spike_factor x the rolling median; counted once per "
        "episode, watchdog-style)."),
    "trainer.nonfinite_skips": MetricSpec(
        "counter", (),
        "Train steps whose update was skipped in-trace because the loss "
        "or global update norm was non-finite (state kept bit-identical; "
        "counted from the trailing fetch)."),
    "trainer.preempted": MetricSpec(
        "counter", (), "Preemption signals honored at a step boundary."),
    "trainer.rollbacks": MetricSpec(
        "counter", (),
        "Guardian rollbacks: restore the last good checkpoint and replay "
        "the data stream to the same cursor."),
    "trainer.step_s": MetricSpec(
        "histogram", (), "Per-step wall time seen by the Trainer."),
    # observability/watchdog.py
    "watchdog.anomalies": MetricSpec(
        "counter", ("kind",),
        "Anomalies latched by the runtime watchdog (kind: slow_step | "
        "ingest_stall | retrace | goodput_collapse | ingest_error | "
        "loss_spike)."),
}


def lookup(name):
    """The MetricSpec for a metric name — exact match first, then the
    longest registered prefix (names registered with a trailing '.').
    None when uncataloged."""
    spec = CATALOG.get(name)
    if spec is not None:
        return spec
    best = None
    for key, s in CATALOG.items():
        if key.endswith(".") and name.startswith(key):
            if best is None or len(key) > len(best[0]):
                best = (key, s)
    return best[1] if best else None


def help_for(name):
    """HELP text for the exporter: cataloged help, or ''."""
    spec = lookup(name)
    return spec.help if spec else ""


def preregister(names, registry=None):
    """Instantiate cataloged metrics ahead of first use so /metrics
    advertises them (HELP/TYPE) before any traffic — the serving engine
    does this for the serve.* family at construction."""
    from paddle_tpu_torch.observability import metrics as _metrics
    reg = registry if registry is not None else _metrics.registry()
    out = []
    for name in names:
        spec = lookup(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not in the catalog")
        out.append(getattr(reg, spec.kind)(name, help=spec.help))
    return out
