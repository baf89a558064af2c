"""Fleet router: N serving-engine replicas behind one front door, so a
replica's loss costs capacity, not availability (ref:
``paddle_tpu/serving/fleet.py``).

  dispatch   least-loaded and priority-aware (the engine's admission key,
             fleet-wide), with per-replica queue bounds, a global
             admission limit and expired pending work shed; a replica
             whose prefix cache already holds a request's leading prompt
             pages wins unless it is overloaded (``fleet.affinity_hits``).
  liveness   each replica is pinged every healthy round through the
             ``fleet.heartbeat`` fault point (``parallel/heartbeat.py``);
             a silent replica goes ``stalled`` (no new dispatch) and, past
             ``heartbeat_dead_factor x heartbeat_s``, dead.
  failover   on a replica's death (a step error past the engine's own
             recovery budget, a kill, heartbeat loss) its in-flight work
             is re-routed from the router's host mirror (prompt + tokens,
             synced each round from ``engine.export_inflight()``) through
             ``engine.adopt()``: a greedy re-route finishes token-exact,
             with its submit, first-token and deadline times kept.
  respawn    a dead replica respawns under its ``RetryBudget``
             (``fleet.respawn`` fault point); past the budget it stays
             dead and the fleet serves on; with none left alive every
             outstanding request fails before the error is re-raised.
  degrade    a replica watchdog's anomaly comes up ``anomaly_sink``: the
             router writes one flight bundle for the fleet, may spawn a
             replica, and sheds expired or lowest-priority pending work.
  drain      ``drain()`` quiesces replicas one at a time while the rest
             take the backlog, and retires every accepted request.
  deploy     ``deploy(ckpt, version=)`` swaps weights replica by replica
             (drain, rebuild) with no downtime; a checkpoint is restored
             and crc32-verified before any replica is touched, and a
             failure rolls swapped replicas back. Every retirement is
             tagged with its version (``fleet.version_retirements``).
  canary     ``deploy(..., canary=True)`` swaps one replica and routes a
             ``canary_weight`` fraction of fresh traffic to it; a canary
             goodput below the baseline's by ``canary_margin`` rolls it
             back (``fleet.canary_aborts``). A request never changes
             version once it has tokens.
  autoscale  backlog spawns replicas up to ``autoscale_max``, slack
             drains them (gracefully) down to ``autoscale_min``, one
             action per ``scale_cooldown_s`` (``fleet.scale_events``).
  disagg     ``prefill_replicas=N`` makes the first N replicas prefill
             replicas: a prompt longer than the engine's ``prefill_len``
             runs its prefill and first token there, then hands off to a
             decode replica through the same adopt replay
             (``fleet.handoffs``); a role with no live replica degrades
             to mixed routing.

Port-specific design. The engine takes a module, so the version store
maps a version to a module on the card, and replicas on one version share
it: N replicas hold one copy of the weights. Every replica's engine is
built on the baseline module's device, and a module on another device is
refused; the router never builds a CPU engine beside card engines. A
kernel error inside a replica's step goes the reference's way (the
engine's step recovery, then failover and respawn, then ``_fail_all``):
nothing switches to a plain version. Replicas step one after another on
the one stream of the host thread (K7's per-device ticket buffer is
shared safely so). The reference's ``fleet_*`` flags become
:class:`FleetConfig` defaults.

``trace_fleet`` is a module setting (:func:`configure`), on by default
and off with ``PT_FLAGS_trace_fleet=0``: on, ``submit()`` mints each
request's durable trace id and every dispatch carries a child span of
it; off, no id is minted and dispatch passes no context (the engine
falls back to its own run-scoped ids). bench.py's untraced window turns
it off together with the flight ring (``flight.configure(ring=0)``).

Replicas are in-process by default. :class:`SubprocessReplica` and
:func:`replica_worker_loop` run an engine in a child process, a fresh
interpreter started with ``subprocess.Popen(argv)``, over the file
transport of ``parallel/launch.py host_allgather``: one command/response
exchange a round, generation-suffixed so a respawned worker never reads
its dead predecessor's files. A child on the card has a CUDA context of
its own, so a sticky CUDA error there (a device-side assert, an illegal
address) ends that process alone, and the router fails its work over as
for any replica death.

    router = FleetRouter(GPTDecoder(cfg), FleetConfig(num_replicas=3))
    fid = router.submit([1, 2, 3], max_new=32)
    finished = router.drain()
"""

import collections
import copy
import dataclasses
import itertools
import json
import os
import subprocess
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.retry import RetryBudget, RetryPolicy
from paddle_tpu_torch.core.settings import env_default
from paddle_tpu_torch.observability import catalog as _catalog
from paddle_tpu_torch.observability import flight as _flight
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import trace as _trace
from paddle_tpu_torch.observability.exporter import start_metrics_server
from paddle_tpu_torch.parallel import launch as _launch
from paddle_tpu_torch.parallel.heartbeat import STALLED, HeartBeatMonitor
from paddle_tpu_torch.serving.engine import ServeConfig, ServingEngine
from paddle_tpu_torch.testing.chaos import fault_point

_TERMINAL = ("done", "rejected", "shed", "cancelled", "failed")

#: the reference's ``trace_fleet`` flag as a module setting
_SETTINGS = {"trace_fleet": env_default("trace_fleet", True)}

_FLEET_METRICS = (
    "fleet.replicas", "fleet.failovers", "fleet.rerouted",
    "fleet.dispatch_depth", "fleet.respawns", "fleet.affinity_hits",
    "fleet.version_retirements", "fleet.deploys", "fleet.scale_events",
    "fleet.canary_aborts", "fleet.handoffs")


def configure(trace_fleet=None):
    """Set ``trace_fleet`` (None leaves it as it is); returns the
    settings."""
    if trace_fleet is not None:
        _SETTINGS["trace_fleet"] = bool(trace_fleet)
    return dict(_SETTINGS)


class ReplicaDead(RuntimeError):
    """A replica handle was used after its engine died."""


class DeployAborted(RuntimeError):
    """A rolling deploy was aborted (a corrupt checkpoint, a draining
    fleet, or a failed swap that rolled back); the fleet keeps serving
    the versions it had."""


@dataclasses.dataclass
class FleetConfig:
    """Defaults are the reference's flag defaults."""
    num_replicas: int = 1         # serve_replicas
    heartbeat_s: float = 1.0      # fleet_heartbeat_s
    heartbeat_dead_factor: float = 10.0   # silent this many heartbeats
    #                               past the stall mark -> declared dead
    respawn_budget: int = 3       # fleet_respawn_budget
    drain_timeout_s: float = 120.0    # fleet_drain_timeout_s; 0 = none
    admission_limit: int = 0      # pending + dispatched cap; 0 = off
    replica_queue_limit: int = 0  # queued-per-replica dispatch bound;
    #                               0 -> 2 x the engine's decode slots
    metrics_port: int = 0         # metrics_port; 0 = off
    model_id: str = "model"       # dispatch identity: model_id@version
    baseline_version: str = "v0"  # the construction-time weights' tag
    canary_weight: float = 0.1    # fleet_canary_weight
    canary_margin: float = 0.1    # canary goodput this far below the
    #                               baseline's -> automatic abort
    canary_min_retired: int = 5   # retirements per version before the
    #                               canary comparison is trusted
    autoscale_min: int = 1        # fleet_autoscale_min
    autoscale_max: int = 0        # fleet_autoscale_max; 0 = off
    scale_cooldown_s: float = 5.0     # fleet_scale_cooldown_s
    deploy_verify: bool = True    # fleet_deploy_verify
    prefill_replicas: int = 0     # fleet_prefill_replicas; 0 = mixed

    def resolve(self):
        enforce(self.num_replicas >= 1, "fleet needs at least 1 replica")
        enforce(self.prefill_replicas >= 0,
                "prefill_replicas must be >= 0")
        enforce(self.heartbeat_s > 0, "heartbeat_s must be > 0")
        enforce(0.0 <= self.canary_weight <= 1.0,
                "canary_weight must be in [0, 1]")
        return self


@dataclasses.dataclass
class FleetRequest:
    """The router's durable record of one accepted request: the failover
    mirror. ``tokens`` is synced from the owning replica every healthy
    round, so a later death replays prompt + tokens token-exact."""
    id: int
    prompt: np.ndarray
    max_new: int
    eos_id: int = None
    tokens: list = dataclasses.field(default_factory=list)
    status: str = "pending"       # pending -> dispatched -> terminal
    priority: int = 0
    temperature: float = None     # per-request sampling (None: the
    top_k: int = None             #   engine's defaults); the seed is
    top_p: float = None           #   pinned at submit, so a re-route
    seed: int = None              #   re-draws the same stream
    deadline_t: float = None      # absolute router-clock deadline
    submit_t: float = None
    first_token_t: float = None
    done_t: float = None
    replica: int = None           # owning (then completing) replica
    replica_rid: int = None       # the replica-local request id
    version: str = None           # chosen at routing, then pinned once
    #                               the request has tokens
    reroutes: int = 0             # failover re-dispatches survived
    phase: str = None             # disaggregation: None = mixed,
    #                               "prefill" = on its prefill leg,
    #                               "decode" = handed off
    retire_reason: str = None
    slo_ok: bool = None
    retriable: bool = False
    trace_id: str = None          # durable fleet trace id, minted at
    #                               submit while trace_fleet is on
    next_span: int = 0            # each dispatch is span "hop<N>"

    @property
    def output(self):
        """prompt + generated tokens (the generate()-shaped sequence)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


def _newly_terminal(engine, reported):
    """Engine requests that reached a terminal status and were not
    reported to the router yet (``reported`` is updated), retirements
    outside ``step()`` included (watchdog shedding)."""
    out = [r for rid, r in engine.requests.items()
           if r.status in _TERMINAL and rid not in reported]
    reported.update(r.id for r in out)
    return sorted(out, key=lambda r: r.id)


class InProcessReplica:
    """A ServingEngine behind the handle the router drives (dispatch,
    step, load, kill, respawn). ``kill()`` freezes the handle as a
    process death would: every later call raises ReplicaDead, and the
    router recovers from its own mirror."""

    def __init__(self, factory, anomaly_sink=None):
        self._factory = factory
        self._sink = anomaly_sink
        self.engine = None
        self._dead = False
        self._reported = set()
        self.respawn()

    def respawn(self):
        """A fresh engine from the factory (fresh pools). A failing
        factory leaves the old engine in place."""
        eng = self._factory()
        if self.engine is not None:
            self.engine.close()
        self.engine = eng
        if self._sink is not None:
            self.engine.anomaly_sink = self._sink
        self._dead = False
        self._reported = set()

    def alive(self):
        return not self._dead

    def kill(self):
        self._dead = True

    def _check(self):
        if self._dead:
            raise ReplicaDead("in-process replica killed")

    def dispatch(self, specs):
        self._check()
        return [self.engine.adopt(
            spec["prompt"], tokens=spec["tokens"],
            max_new=spec["max_new"], eos_id=spec["eos_id"],
            priority=spec["priority"], deadline_t=spec["deadline_t"],
            submit_t=spec["submit_t"],
            first_token_t=spec["first_token_t"],
            origin=spec.get("origin", "fleet"),
            temperature=spec.get("temperature"),
            top_k=spec.get("top_k"), top_p=spec.get("top_p"),
            seed=spec.get("seed"),
            trace=spec.get("trace")) for spec in specs]

    def cancel(self, rid):
        self._check()
        return self.engine.cancel(rid)

    def step(self):
        self._check()
        eng = self.engine
        if eng._queue or eng._running:
            eng.step()
        # every retirement since the last round, the ones outside step()
        # (watchdog shedding) too
        fin = _newly_terminal(eng, self._reported)
        return {
            "finished": [dict(rid=r.id, status=r.status,
                              reason=r.retire_reason,
                              tokens=list(r.tokens), slo_ok=r.slo_ok,
                              first_token_t=r.first_token_t)
                         for r in fin],
            "inflight": eng.export_inflight(),
            "queued": len(eng._queue),
            "active": len(eng._running),
        }

    def queued(self):
        return 0 if self._dead else len(self.engine._queue)

    def load(self):
        if self._dead:
            return 0
        return len(self.engine._queue) + len(self.engine._running)

    def telemetry(self):
        eng = self.engine
        return dict(goodput=round(eng.goodput(), 4), slo=eng.slo_stats(),
                    decode_steps=eng.decode_steps,
                    recoveries=eng.recoveries, queued=self.queued(),
                    active=0 if self._dead else len(eng._running),
                    alive=self.alive(), version=eng.version)

    def close(self):
        if self.engine is not None:
            self.engine.close()


def _pack(obj):
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy()


def _unpack(arr):
    return json.loads(bytes(np.asarray(arr, np.uint8).tolist()).decode())


class SubprocessReplica:
    """A replica whose engine runs in a child process (a replica kill is a
    process kill), driven over the ``host_allgather`` file transport: one
    command/response exchange a round (rank 0 the router, rank 1 the
    worker). ``generation`` (the respawn count) suffixes every exchange
    file, so a respawned worker that restarts its sequence at 0 never
    reads its dead predecessor's payloads.

    ``argv`` starts the worker (a script ending in
    ``replica_worker_loop(ServingEngine(...))``) as a fresh interpreter;
    the child inherits this process's environment, ``env`` on top, and
    ``PT_FLEET_XDIR``, ``PT_FLEET_REPLICA`` and ``PT_FLEET_GENERATION``.
    Wire times are relative (ages, seconds remaining): the child's
    ``perf_counter`` shares no epoch with the router's, so absolute
    router times are converted at this boundary in both directions. A
    child that does not answer within ``timeout_s`` is dead
    (``ReplicaDead``); one that has exited is caught by ``alive()`` before
    the exchange."""

    def __init__(self, argv, exchange_dir, replica=0, env=None,
                 timeout_s=60.0, clock=time.perf_counter):
        self.argv = list(argv)
        self.exchange_dir = exchange_dir
        self.replica = replica
        self.timeout_s = timeout_s
        self._clock = clock
        self._env = dict(env or {})
        self.generation = -1
        self._proc = None
        self._seq = 0
        self._lids = itertools.count()
        self._outbox = []            # wire specs awaiting the next round
        self._rid_to_lid = {}
        self._counts = (0, 0)        # (queued, active) from last response
        self.respawn()

    def respawn(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self.generation += 1
        self._seq = 0
        self._outbox = []
        self._rid_to_lid = {}
        self._counts = (0, 0)
        env = dict(os.environ)
        env.update(self._env)
        env.update({
            "PT_FLEET_XDIR": self.exchange_dir,
            "PT_FLEET_REPLICA": str(self.replica),
            "PT_FLEET_GENERATION": str(self.generation),
        })
        self._proc = subprocess.Popen(self.argv, env=env)

    def alive(self):
        return self._proc is not None and self._proc.poll() is None

    def kill(self):
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()     # reaped: alive() is False from here on

    def dispatch(self, specs):
        lids = []
        now = self._clock()
        for spec in specs:
            lid = next(self._lids)
            self._outbox.append(dict(
                key=lid,
                prompt=np.asarray(spec["prompt"]).astype(int).tolist(),
                tokens=[int(t) for t in spec["tokens"]],
                max_new=int(spec["max_new"]),
                eos_id=(None if spec["eos_id"] is None
                        else int(spec["eos_id"])),
                priority=int(spec["priority"]),
                origin=spec.get("origin", "fleet"),
                temperature=(None if spec.get("temperature") is None
                             else float(spec["temperature"])),
                top_k=(None if spec.get("top_k") is None
                       else int(spec["top_k"])),
                top_p=(None if spec.get("top_p") is None
                       else float(spec["top_p"])),
                seed=(None if spec.get("seed") is None
                      else int(spec["seed"])),
                deadline_in_s=(None if spec["deadline_t"] is None
                               else spec["deadline_t"] - now),
                submit_age_s=(0.0 if spec["submit_t"] is None
                              else now - spec["submit_t"]),
                first_token_age_s=(None if spec["first_token_t"] is None
                                   else now - spec["first_token_t"]),
                trace=spec.get("trace")))   # already a JSON-safe dict
            lids.append(lid)
        return lids

    def cancel(self, rid):
        return False                  # not carried over the wire

    def _exchange(self, tag, payload):
        gathered = _launch.host_allgather(
            payload, 0, 2, self.exchange_dir, f"p{self.replica}.{tag}",
            timeout=self.timeout_s, generation=self.generation,
            ragged=True)
        return gathered[1]

    def step(self):
        if not self.alive():
            raise ReplicaDead(
                f"subprocess replica {self.replica} exited "
                f"rc={self._proc.returncode}")
        cmd = {"op": "round", "submit": self._outbox}
        seq = self._seq
        try:
            self._exchange(f"q{seq}", _pack(cmd))
            resp = _unpack(self._exchange(f"r{seq}", _pack({})))
        except TimeoutError as e:
            raise ReplicaDead(
                f"subprocess replica {self.replica} unresponsive: "
                f"{e}") from e
        self._seq += 1
        self._outbox = []
        now = self._clock()

        def abs_t(age):
            return None if age is None else now - age

        for sub in resp.get("submitted", []):
            self._rid_to_lid[sub["rid"]] = sub["key"]
        report = {"finished": [], "inflight": [],
                  "queued": int(resp.get("queued", 0)),
                  "active": int(resp.get("active", 0))}
        for fin in resp.get("finished", []):
            lid = self._rid_to_lid.pop(fin["rid"], None)
            if lid is None:
                continue
            report["finished"].append(dict(
                rid=lid, status=fin["status"], reason=fin["reason"],
                tokens=fin["tokens"], slo_ok=fin["slo_ok"],
                first_token_t=abs_t(fin.get("first_token_age_s"))))
        for inf in resp.get("inflight", []):
            lid = self._rid_to_lid.get(inf["rid"])
            if lid is None:
                continue
            report["inflight"].append(dict(
                rid=lid, status=inf["status"], tokens=inf["tokens"],
                first_token_t=abs_t(inf.get("first_token_age_s"))))
        self._counts = (report["queued"], report["active"])
        return report

    def queued(self):
        return self._counts[0] + len(self._outbox)

    def load(self):
        return self._counts[0] + self._counts[1] + len(self._outbox)

    def telemetry(self):
        return dict(alive=self.alive(), generation=self.generation,
                    queued=self._counts[0], active=self._counts[1])

    def close(self):
        """Send ``stop`` (the worker finishes its round and returns
        without a response) and wait for the child; kill it if it does
        not exit within ``timeout_s``."""
        if self.alive():
            try:
                self._exchange(f"q{self._seq}",
                               _pack({"op": "stop", "submit": []}))
                self._proc.wait(timeout=self.timeout_s)
            except Exception:
                self.kill()
        self._proc = None


def replica_worker_loop(engine, exchange_dir=None, replica=None,
                        generation=None, timeout_s=60.0,
                        clock=time.perf_counter):
    """The child's side of :class:`SubprocessReplica`: gather one command
    a round, ``adopt()`` its submissions and ``step()`` the engine, then
    publish the response; return on ``stop`` without one. The arguments
    default to the ``PT_FLEET_*`` environment the parent set, so a worker
    script ends in ``replica_worker_loop(ServingEngine(...))``.
    ``timeout_s`` bounds each wait for the router's next command."""
    xdir = exchange_dir or os.environ["PT_FLEET_XDIR"]
    rep = int(os.environ.get("PT_FLEET_REPLICA", 0)
              if replica is None else replica)
    gen = int(os.environ.get("PT_FLEET_GENERATION", 0)
              if generation is None else generation)
    engine.replica = rep          # stamped on every trace event
    seq = 0
    reported = set()
    while True:
        gathered = _launch.host_allgather(
            _pack({}), 1, 2, xdir, f"p{rep}.q{seq}", timeout=timeout_s,
            generation=gen, ragged=True)
        cmd = _unpack(gathered[0])
        now = clock()
        submitted = []
        for spec in cmd.get("submit", []):
            rid = engine.adopt(
                np.asarray(spec["prompt"], np.int32),
                tokens=spec["tokens"], max_new=spec["max_new"],
                eos_id=spec["eos_id"], priority=spec["priority"],
                deadline_t=(None if spec["deadline_in_s"] is None
                            else now + spec["deadline_in_s"]),
                submit_t=now - spec["submit_age_s"],
                first_token_t=(None if spec["first_token_age_s"] is None
                               else now - spec["first_token_age_s"]),
                origin=spec.get("origin", "fleet"),
                temperature=spec.get("temperature"),
                top_k=spec.get("top_k"), top_p=spec.get("top_p"),
                seed=spec.get("seed"), trace=spec.get("trace"))
            submitted.append({"key": spec["key"], "rid": rid})
        if engine._queue or engine._running:
            engine.step()
        if cmd.get("op") == "stop":
            return                # close() gathers no response: one
            #                       published here would wait for a
            #                       router file that never comes
        fin = _newly_terminal(engine, reported)
        now = clock()

        def age(t):
            return None if t is None else now - t

        resp = {
            "submitted": submitted,
            "finished": [dict(rid=r.id, status=r.status,
                              reason=r.retire_reason,
                              tokens=list(r.tokens), slo_ok=r.slo_ok,
                              first_token_age_s=age(r.first_token_t))
                         for r in fin],
            "inflight": [dict(rid=e["rid"], status=e["status"],
                              tokens=e["tokens"],
                              first_token_age_s=age(e["first_token_t"]))
                         for e in engine.export_inflight()],
            "queued": len(engine._queue),
            "active": len(engine._running),
        }
        _launch.host_allgather(_pack(resp), 1, 2, xdir, f"p{rep}.r{seq}",
                               timeout=timeout_s, generation=gen,
                               ragged=True)
        seq += 1


class FleetRouter:
    """submit()/step()/drain() over N engine replicas with failover.

    ``model`` is a :class:`~paddle_tpu_torch.models.gpt.GPTDecoder` (the
    baseline version's weights, on the device every replica runs on);
    ``serve_config`` the template each replica's engine is built from;
    ``replicas`` caller-built handles instead. ``clock`` is the router's
    (and its heartbeat monitor's) clock; ``sleep`` takes the respawn and
    engine-recovery backoffs, injectable for tests."""

    def __init__(self, model=None, config=None, serve_config=None,
                 replicas=None, clock=time.perf_counter, sleep=time.sleep):
        self.cfg = (config or FleetConfig()).resolve()
        cfg = self.cfg
        self._clock = clock
        self._sleep = sleep
        _catalog.preregister(_FLEET_METRICS)
        # One re-entrant lock guards the router's mirror: submit() and
        # cancel() come from client threads while step() and drain() run
        # the rounds, and an engine watchdog's anomaly callback re-enters
        # shed_pending() from under a step that holds it. It is taken
        # before any engine's lock. Made before the replicas: the
        # engine factory reads the version assignment under it.
        self._lock = threading.RLock()
        # deploy() and drain() drive many rounds; this mutex keeps them
        # from interleaving half done
        self._ops_lock = threading.Lock()
        self._model = model
        self._device = model.device if model is not None else None
        self._serve_template = serve_config or ServeConfig()
        # version -> module; replicas on one version share it, and every
        # respawn or swap builds its engine from this store
        self._weights = {}
        if model is not None:
            self._weights[cfg.baseline_version] = model
        self._baseline_version = cfg.baseline_version
        self._canary_version = None
        self._deploying = None
        self._pending_swaps = {}      # replica -> version | None (None: a
        #                               scale-down retire)
        self._version_stats = {}      # version -> [retired, slo_ok]
        self._last_scale_t = None
        self.ops_log = []             # deploy/scale/canary event records
        if replicas is not None:
            self._replicas = list(replicas)
            self._versions = [cfg.baseline_version] * len(self._replicas)
            for i, h in enumerate(self._replicas):
                # the router owns replica index and version identity
                eng = getattr(h, "engine", None)
                if eng is not None:
                    if eng.replica is None:
                        eng.replica = i
                    if eng.version is None:
                        eng.version = (f"{cfg.model_id}"
                                       f"@{cfg.baseline_version}")
        else:
            enforce(model is not None,
                    "FleetRouter needs a model or replica handles")
            self._versions = [cfg.baseline_version] * cfg.num_replicas
            self._replicas = [
                InProcessReplica(self._engine_factory(i),
                                 anomaly_sink=self._sink_for(i))
                for i in range(cfg.num_replicas)]
        n = len(self._replicas)
        in_process = [h for h in self._replicas
                      if isinstance(h, InProcessReplica)]
        template = (in_process[0].engine.cfg if in_process
                    else self._serve_template)
        # submit() mirrors ServingEngine.submit's defaults, from the
        # replicas' own serve config
        self._default_max_new = int(template.default_max_new)
        self._default_deadline_s = float(template.default_deadline_s)
        if cfg.replica_queue_limit <= 0:
            slots = max((h.engine.cfg.num_slots for h in in_process),
                        default=4)
            cfg.replica_queue_limit = max(2, 2 * slots)
        self._states = ["live"] * n
        # disaggregation: the first prefill_replicas replicas are the
        # prefill role, the rest decode; empty = every replica mixed
        if cfg.prefill_replicas > 0:
            enforce(cfg.prefill_replicas < n,
                    "prefill_replicas must leave at least one decode "
                    "replica")
            self._roles = ["prefill" if i < cfg.prefill_replicas
                           else "decode" for i in range(n)]
        else:
            self._roles = []
        # a prompt longer than this is a multi-chunk admission: the work
        # disaggregation moves off the decode replicas
        self._prefill_cut = int(template.prefill_len)
        self.handoffs = 0
        self._monitor = HeartBeatMonitor(
            n, timeout_s=cfg.heartbeat_s, interval_s=cfg.heartbeat_s,
            clock=clock)
        for i in range(n):
            self._monitor.update(i)
        self._budgets = [self._new_budget() for _ in range(n)]
        self.requests = {}            # fid -> FleetRequest
        self._pending = collections.deque()
        self._by_replica = {}         # (replica, replica rid) -> fid
        self._ids = itertools.count()
        self._step_no = 0
        self._draining = False
        self.failovers = 0
        self._trace_run = _trace.mint_run()
        self._flight_dumped = set()   # anomaly kinds already bundled
        self._metrics_server = start_metrics_server(cfg.metrics_port)
        self._publish()

    def _new_budget(self):
        return RetryBudget(RetryPolicy(
            max_attempts=self.cfg.respawn_budget + 1, sleep=self._sleep),
            "fleet.respawn")

    def _engine_factory(self, i):
        """Replica i's engine on its current version: a failure respawn
        comes back on the version it served, and a deploy swap changes
        ``self._versions[i]`` first, then respawns through this."""
        def build():
            sc = dataclasses.replace(self._serve_template)
            sc.metrics_port = 0       # one exporter, the router's
            if isinstance(sc.run_log, str) and sc.run_log:
                # one RunLog per replica: "{replica}" templates, else an
                # .r<i> suffix (not a digit, so rotation reads skip it)
                sc.run_log = (sc.run_log.format(replica=i)
                              if "{replica}" in sc.run_log
                              else f"{sc.run_log}.r{i}")
            with self._lock:
                version = self._versions[i]
                module = self._weights[version]
            enforce(module.device == self._device,
                    f"version {version!r} is on {module.device}, the "
                    f"fleet on {self._device}")
            sc.model_version = f"{self.cfg.model_id}@{version}"
            eng = ServingEngine(module, sc, sleep=self._sleep)
            eng.replica = i           # stamped on every trace event
            return eng
        return build

    def _sink_for(self, i):
        return lambda event: self._on_replica_anomaly(i, event)

    # -- client surface ---------------------------------------------------

    def submit(self, prompt, max_new=None, eos_id=None, deadline_s=None,
               priority=0, temperature=None, top_k=None, top_p=None,
               seed=None):
        """Accept a request fleet-wide; returns the fleet request id.
        ServingEngine.submit's semantics (the serve config's default
        deadline, infeasible deadlines rejected, retriable rejections),
        with the global admission limit in place of the engine's queue
        bound. The sampling seed is pinned here (derived from the fleet
        id when not given), so a re-route re-draws the same stream."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            rec = FleetRequest(id=next(self._ids), prompt=prompt,
                               max_new=(max_new if max_new is not None
                                        else self._default_max_new),
                               eos_id=eos_id, priority=int(priority))
            rec.temperature = temperature
            rec.top_k = top_k
            rec.top_p = top_p
            rec.seed = ((1_000_003 * rec.id + 12_345) & 0xFFFFFFFF
                        if seed is None else int(seed) & 0xFFFFFFFF)
            if _SETTINGS["trace_fleet"]:
                # the durable context, minted once; every hop derives a
                # child span of it
                rec.trace_id = f"{self._trace_run}/{rec.id}"
            rec.submit_t = self._clock()
            self.requests[rec.id] = rec
            _metrics.counter("serve.requests").inc(status="submitted")
            if self._draining:
                rec.retriable = True
                self._retire(rec, "rejected", "draining")
                return rec.id
            if deadline_s is None and self._default_deadline_s > 0:
                deadline_s = self._default_deadline_s
            if deadline_s is not None:
                if deadline_s <= 0:
                    rec.retriable = True
                    self._retire(rec, "rejected", "infeasible_deadline")
                    return rec.id
                rec.deadline_t = rec.submit_t + float(deadline_s)
            # rec is already counted as pending: admit while <= limit
            if self.cfg.admission_limit and (
                    self._outstanding() > self.cfg.admission_limit):
                rec.retriable = True
                self._retire(rec, "rejected", "fleet_admission_limit")
                return rec.id
            self._pending.append(rec)
            self._dispatch([])
            return rec.id

    def cancel(self, fid):
        """Cancel a fleet request: a pending one retires at once, a
        dispatched one cancels at its replica."""
        with self._lock:
            rec = self.requests.get(fid)
            if rec is None or rec.status in _TERMINAL:
                return False
            if rec.status == "pending":
                self._pending.remove(rec)
                self._retire(rec, "cancelled", "cancelled", account=False)
                return True
            handle = self._replicas[rec.replica]
            if handle.cancel(rec.replica_rid):
                self._by_replica.pop((rec.replica, rec.replica_rid), None)
                self._retire(rec, "cancelled", "cancelled", account=False,
                             count=False)
                return True
            return False

    def step(self):
        """One round: dispatch pending work, step every live replica
        (syncing the failover mirror), ping heartbeats, scan for stalls
        and deaths, advance swaps, check the canary, autoscale. Returns
        the fleet requests that reached a terminal status this round."""
        with self._lock:
            finished = []
            self._dispatch(finished)
            for i, handle in enumerate(list(self._replicas)):
                if self._states[i] in ("dead", "retired"):
                    continue
                if not handle.alive():
                    self._on_replica_failure(
                        i, ReplicaDead(f"replica {i} process died"),
                        finished)
                    continue
                if (handle.load() == 0
                        and not self._replica_outstanding(i)):
                    self._ping(i)
                    continue
                # load > 0, or the mirror still shows dispatched work the
                # replica no longer holds (an out-of-band retirement)
                try:
                    report = handle.step()
                except Exception as e:
                    self._on_replica_failure(i, e, finished)
                    continue
                self._budgets[i].success()
                self._ping(i)
                self._sync(i, report, finished)
            self._scan_heartbeats(finished)
            self._advance_swaps(finished)
            self._check_canary()
            self._autoscale()
            self._publish()
            self._step_no += 1
            return finished

    def drain(self, max_steps=200000):
        """Retire every accepted request, quiescing replicas one at a
        time (no new dispatch to a draining replica while the rest take
        the backlog); once all drain, leftover pending work still goes
        to the least-loaded alive one. New submissions are rejected,
        retriable. Bounded by ``drain_timeout_s``; waits for a deploy in
        progress to finish first."""
        with self._ops_lock:
            return self._drain_locked(max_steps)

    def _drain_locked(self, max_steps):
        with self._lock:
            self._draining = True
        t0 = self._clock()
        budget = self.cfg.drain_timeout_s
        out = []

        def check(i=None):
            if budget > 0 and self._clock() - t0 > budget:
                with self._lock:
                    left = [r.id for r in self.requests.values()
                            if r.status not in _TERMINAL]
                raise RuntimeError(
                    f"fleet drain: {len(left)} requests not terminal "
                    f"after {budget}s"
                    + (f" (quiescing replica {i})" if i is not None
                       else ""))

        # the lock is released between rounds, so late clients still
        # reach submit() (and its retriable rejection)
        for _ in range(max_steps):
            with self._lock:
                if all(s != "live" for s in self._states):
                    break
                target = next(i for i, s in enumerate(self._states)
                              if s == "live")
                self._states[target] = "draining"
            while True:
                with self._lock:
                    more = (self._states[target] == "draining"
                            and self._replica_outstanding(target))
                if not more:
                    break
                out.extend(self.step())
                check(target)
        while True:
            with self._lock:
                left = any(r.status not in _TERMINAL
                           for r in self.requests.values())
            if not left:
                break
            out.extend(self.step())
            check()
        with self._lock:
            self._publish()
        return out

    def kill_replica(self, i):
        """Simulate replica i's death mid-decode: the next step() finds
        the corpse and runs the failover path a real crash takes."""
        self._replicas[i].kill()

    def shed_pending(self, cause="overload"):
        """Fleet-wide load shedding: shed every expired pending request,
        or, when none expired, the lowest-priority / latest-deadline
        one."""
        with self._lock:
            now = self._clock()
            shed = [(r, "deadline_expired") for r in self._pending
                    if r.deadline_t is not None and now > r.deadline_t]
            if not shed and self._pending:
                shed = [(min(self._pending, key=self._victim_key), cause)]
            for rec, why in shed:
                self._pending.remove(rec)
                _metrics.counter("serve.shed").inc(cause=cause)
                self._retire(rec, "shed", why)
            return [rec.id for rec, _ in shed]

    def goodput(self):
        """SLO-met fraction of the retirements that count (cancellations
        do not), wherever each request completed."""
        with self._lock:
            done = [r for r in self.requests.values()
                    if r.status in _TERMINAL and r.status != "cancelled"]
            if not done:
                return 1.0
            return sum(1 for r in done if r.slo_ok) / len(done)

    def telemetry(self):
        """Per-replica and fleet-level snapshot."""
        with self._lock:
            return {
                "replicas": [h.telemetry() for h in self._replicas],
                "states": list(self._states),
                "failovers": self.failovers,
                "rerouted": int(sum(r.reroutes
                                    for r in self.requests.values())),
                "respawn_failures": [b.failures for b in self._budgets],
                "goodput": round(self.goodput(), 4),
                "versions": list(self._versions),
                "roles": list(self._roles),
                "handoffs": self.handoffs,
                "baseline_version": self._baseline_version,
                "canary_version": self._canary_version,
                "version_stats": {
                    v: {"retired": s[0], "slo_ok": s[1],
                        "goodput": round(s[1] / s[0], 4) if s[0] else 1.0}
                    for v, s in sorted(self._version_stats.items())},
                "ops_log": [dict(e) for e in self.ops_log],
            }

    def close(self):
        for handle in self._replicas:
            handle.close()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    # -- dispatch ---------------------------------------------------------

    def _admission_key(self, rec):
        dl = rec.deadline_t if rec.deadline_t is not None else float("inf")
        return (-rec.priority, dl, rec.id)

    def _victim_key(self, rec):
        dl = rec.deadline_t if rec.deadline_t is not None else float("inf")
        return (rec.priority, -dl, -rec.id)

    def _outstanding(self):
        return sum(1 for r in self.requests.values()
                   if r.status in ("pending", "dispatched"))

    def _replica_outstanding(self, i):
        return sum(1 for r in self.requests.values()
                   if r.status == "dispatched" and r.replica == i)

    def _eligible_replicas(self):
        live = [i for i, s in enumerate(self._states) if s == "live"]
        if live:
            return live
        # every survivor is draining: accepted work still lands on an
        # alive one, but not on one quiescing toward a swap or retire
        # (the work waits for the rebuilt replica instead)
        return [i for i, s in enumerate(self._states)
                if s == "draining" and self._replicas[i].alive()
                and i not in self._pending_swaps]

    def _affinity_depth(self, handle, rec):
        """Leading full prompt pages of ``rec`` already in a replica's
        prefix cache (the placement signal); 0 for a handle without an
        engine."""
        eng = getattr(handle, "engine", None)
        return eng.prefix_lookup_depth(rec.prompt) if eng is not None else 0

    def _choose_version(self, rec):
        """Routing version of a fresh request: the canary for a
        ``canary_weight`` fraction of traffic (deterministic per fleet
        id), else the baseline; pins ``rec.version``. A ``fleet.canary``
        fault sends the request to the baseline."""
        if rec.version is not None:
            return rec.version
        version = self._baseline_version
        canary = self._canary_version
        if canary is not None and self.cfg.canary_weight > 0:
            try:
                fault_point("fleet.canary")
                draw = ((1103515245 * (rec.id + 1) + 12345) >> 7) % 1000
                if draw < int(self.cfg.canary_weight * 1000):
                    version = canary
            except Exception:
                pass
        rec.version = version
        return version

    def _pick_replica(self, rec=None):
        """Dispatch target: the least-loaded eligible replica serving the
        request's version, unless a replica's prefix cache holds the
        request's leading pages and is not overloaded against the least
        loaded (then it wins: ``fleet.affinity_hits``). A request that
        already has tokens is pinned hard to its version (draining
        replicas of it included); a fresh one only prefers its version.
        Returns ``(i, handle)`` or None."""
        if rec is not None and rec.version is not None and rec.tokens:
            live, draining = [], []
            for i, s in enumerate(self._states):
                if (s in ("live", "draining")
                        and self._replicas[i].alive()
                        and self._versions[i] == rec.version):
                    (live if s == "live" else draining).append(
                        (self._replicas[i].load(), i, self._replicas[i]))
            # role-matching capacity first within each tier; a role with
            # none degrades to mixed rather than wedge the record
            candidates = (self._role_filter(live, rec)
                          or self._role_filter(draining, rec)
                          or live or draining)
            return min(candidates)[1:] if candidates else None
        candidates = []
        for i in self._eligible_replicas():
            handle = self._replicas[i]
            if handle.queued() >= self.cfg.replica_queue_limit:
                continue
            candidates.append((handle.load(), i, handle))
        candidates = self._role_filter(candidates, rec) or candidates
        if not candidates:
            return None
        if rec is not None:
            want = self._choose_version(rec)
            versioned = [c for c in candidates
                         if self._versions[c[1]] == want]
            if versioned:
                candidates = versioned
        least = min(candidates)
        if rec is not None:
            affine = [c for c in candidates
                      if self._affinity_depth(c[2], rec) > 0]
            if affine:
                load, i, handle = min(affine)
                slack = max(1, self.cfg.replica_queue_limit // 2)
                if load - least[0] <= slack:
                    _metrics.counter("fleet.affinity_hits").inc()
                    return i, handle
        return least[1:]

    def _role_filter(self, candidates, rec):
        """The ``(load, i, handle)`` candidates whose role matches the
        request's phase; empty when the role has no capacity (callers
        then route mixed)."""
        if not self._roles or rec is None:
            return candidates
        want = rec.phase
        if want not in ("prefill", "decode"):
            return candidates
        return [c for c in candidates
                if c[1] < len(self._roles) and self._roles[c[1]] == want]

    def _role_alive(self, role):
        return any(r == role
                   and self._states[i] not in ("dead", "retired")
                   and self._replicas[i].alive()
                   for i, r in enumerate(self._roles))

    def _classify_phase(self, rec):
        """Once per fresh request: a prompt past ``prefill_len`` starts
        on a prefill replica when both roles have alive capacity.
        Requests with tokens are never reclassified."""
        if (not self._roles or rec.phase is not None or rec.tokens
                or rec.max_new <= 1
                or rec.prompt.size <= self._prefill_cut):
            return
        if self._role_alive("prefill") and self._role_alive("decode"):
            rec.phase = "prefill"

    def _dispatch(self, finished):
        now = self._clock()
        for rec in [r for r in self._pending
                    if r.deadline_t is not None and now > r.deadline_t]:
            self._pending.remove(rec)
            _metrics.counter("serve.shed").inc(cause="deadline")
            self._retire(rec, "shed", "deadline_expired", finished)
        while self._pending:
            rec = min(self._pending, key=self._admission_key)
            self._classify_phase(rec)
            target = self._pick_replica(rec)
            if target is None:
                if rec.version is not None and rec.tokens:
                    # pinned to a version no alive replica serves: it can
                    # never adopt safely, so it fails now rather than
                    # wedge the queue
                    self._pending.remove(rec)
                    self._retire(rec, "failed", "version_retired",
                                 finished)
                    continue
                break
            i, handle = target
            try:
                fault_point("fleet.dispatch")
            except Exception:
                break         # stays pending, retried next round
            try:
                rid = handle.dispatch([self._spec_of(rec)])[0]
            except Exception as e:
                self._on_replica_failure(i, e, finished)
                continue
            self._pending.remove(rec)
            rec.status = "dispatched"
            rec.replica = i
            rec.replica_rid = rid
            # tag what actually serves it (a fresh request may have
            # landed on off-version capacity)
            rec.version = self._versions[i]
            self._by_replica[(i, rid)] = rec.id

    def _spec_of(self, rec, origin="fleet"):
        trace = None
        if rec.trace_id is not None:
            # hop0 = first dispatch, hop1 = the next (failover, handoff);
            # the trace id never changes
            trace = _trace.TraceContext(
                rec.trace_id, span_id=f"hop{rec.next_span}",
                parent_span_id="root" if rec.next_span == 0
                else f"hop{rec.next_span - 1}").to_wire()
            rec.next_span += 1
        max_new = rec.max_new
        if rec.reroutes:
            origin = "failover"
        elif rec.phase == "decode":
            origin = "handoff"
        if rec.phase == "prefill":
            # the prefill leg: chunked prefill + exactly the first token
            max_new = 1
            if not rec.reroutes:
                origin = "prefill"
        return dict(prompt=rec.prompt, tokens=list(rec.tokens),
                    max_new=max_new, eos_id=rec.eos_id,
                    priority=rec.priority, deadline_t=rec.deadline_t,
                    submit_t=rec.submit_t,
                    first_token_t=rec.first_token_t,
                    temperature=rec.temperature, top_k=rec.top_k,
                    top_p=rec.top_p, seed=rec.seed, trace=trace,
                    origin=origin)

    # -- live ops: deploy / canary / autoscale ----------------------------

    def _ops_event(self, event, **kw):
        with self._lock:
            rec = dict(event=event, t=self._clock(),
                       at_step=self._step_no, **kw)
            self.ops_log.append(rec)
            return rec

    def version_goodput(self, version):
        """SLO-met fraction of the version's retirements (1.0 before the
        first)."""
        with self._lock:
            st = self._version_stats.get(version)
            if not st or st[0] == 0:
                return 1.0
            return st[1] / st[0]

    def _account_version(self, rec):
        """Tag the retirement with its version and feed the per-version
        tally the canary check reads (cancellations are tagged, not
        tallied)."""
        if rec.version is None:
            rec.version = self._baseline_version
        _metrics.counter("fleet.version_retirements").inc(
            version=rec.version)
        if rec.status != "cancelled":
            st = self._version_stats.setdefault(rec.version, [0, 0])
            st[0] += 1
            if rec.slo_ok:
                st[1] += 1

    def _module_of(self, weights):
        """A module for ``weights``: a module is used as it is (it must
        be on the fleet's device); a state dict (``{name: tensor}`` or a
        checkpoint's ``{"params": {name: tensor}}``) loads into a copy of
        the baseline module, on the same device."""
        if isinstance(weights, torch.nn.Module):
            enforce(weights.device == self._device,
                    f"deployed module on {weights.device}, the fleet on "
                    f"{self._device}")
            return weights.eval()
        params = weights.get("params", weights)
        module = copy.deepcopy(self._weights[self._baseline_version])
        own = dict(module.named_parameters())
        enforce(set(params) == set(own),
                "deployed weights name other parameters than the model's")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(params[name])
        return module.eval()

    def deploy(self, ckpt, version=None, step=None, verify=None,
               canary=False, budget_s=None):
        """Zero-downtime rolling weight swap.

        ``ckpt``: a checkpoint directory (restored through
        ``CheckpointManager`` and crc32-verified before any replica is
        touched; a corrupt manifest raises DeployAborted with the fleet
        untouched; the version tag defaults to the step's meta
        ``model_version``), a module or a state dict (then ``version`` is
        required), or None to promote a stored version (canary to full
        rollout). Each replica then drains and rebuilds on the new
        weights one at a time while the rest take the traffic; a failed
        swap rolls swapped replicas back. ``canary=True`` swaps one
        replica and starts weighted canary routing instead of moving the
        baseline. A draining fleet rejects a deploy."""
        deploys = _metrics.counter("fleet.deploys")
        with self._ops_lock:
            with self._lock:
                if self._draining:
                    deploys.inc(status="rejected")
                    raise DeployAborted("fleet is draining")
                template = self._weights.get(self._baseline_version)
            if verify is None:
                verify = self.cfg.deploy_verify
            got = None
            if ckpt is None:
                enforce(version is not None,
                        "deploy(None) promotes a stored version: "
                        "pass version=")
                with self._lock:
                    module = self._weights.get(version)
                if module is None:
                    deploys.inc(status="aborted")
                    raise DeployAborted(
                        f"no stored weights for version {version!r}")
            elif isinstance(ckpt, str):
                from paddle_tpu_torch.io.checkpoint import CheckpointManager
                try:
                    fault_point("fleet.deploy")
                    mgr = CheckpointManager(ckpt)
                    state, got = mgr.restore(
                        {"params": dict(template.named_parameters())},
                        step=step, verify=verify)
                    if state is None:
                        raise RuntimeError(
                            f"no restorable checkpoint under {ckpt}")
                    module = self._module_of(state)
                except Exception as e:
                    deploys.inc(status="aborted")
                    self._ops_event("deploy_abort", ckpt=str(ckpt),
                                    version=version, error=repr(e))
                    raise DeployAborted(
                        f"checkpoint load/verify failed: {e}") from e
                if version is None:
                    version = (mgr.read_meta(got) or {}).get(
                        "model_version") or f"ckpt-{got}"
            else:
                # a module or state dict: a trusted caller, unverified
                enforce(version is not None,
                        "deploy(weights) needs an explicit version=")
                module = self._module_of(ckpt)
            with self._lock:
                self._weights[version] = module
                self._deploying = version
                old_baseline = self._baseline_version
                if canary:
                    live = [i for i, s in enumerate(self._states)
                            if s == "live"
                            and self._versions[i] != version]
                    if not live:
                        self._deploying = None
                        deploys.inc(status="aborted")
                        raise DeployAborted(
                            "no live replica available for a canary")
                    targets = [min(live, key=lambda i: (
                        self._replicas[i].load(), i))]
                else:
                    # not the replicas queued for a scale-down retire
                    targets = [i for i, s in enumerate(self._states)
                               if s not in ("dead", "retired")
                               and self._versions[i] != version
                               and self._pending_swaps.get(i, "")
                               is not None]
            self._ops_event("deploy_start", version=version,
                            canary=bool(canary), step=got,
                            targets=list(targets))
            deadline = self._clock() + (
                budget_s if budget_s is not None
                else max(self.cfg.drain_timeout_s, 1.0))
            swapped = []              # (replica, its pre-swap version)
            try:
                for i in targets:
                    with self._lock:
                        prev = self._versions[i]
                    if self._swap_replica(i, version, deadline):
                        swapped.append((i, prev))
                        continue
                    # abort: roll swapped replicas back on a fresh budget
                    back_by = self._clock() + max(
                        self.cfg.drain_timeout_s, 1.0)
                    for j, prev_j in swapped:
                        self._swap_replica(j, prev_j, back_by)
                    status = "rolled_back" if swapped else "aborted"
                    deploys.inc(status=status)
                    self._ops_event("deploy_abort", version=version,
                                    failed_replica=i, status=status)
                    raise DeployAborted(
                        f"swap of replica {i} to {version!r} failed; "
                        f"{len(swapped)} replica(s) rolled back")
            finally:
                with self._lock:
                    self._deploying = None
            with self._lock:
                if canary:
                    self._canary_version = version
                else:
                    self._baseline_version = version
                    if self._canary_version == version:
                        self._canary_version = None
            deploys.inc(status="canary" if canary else "ok")
            self._ops_event("deploy_done", version=version,
                            canary=bool(canary),
                            baseline=(old_baseline if canary
                                      else version),
                            replicas=[i for i, _ in swapped])
            return version

    def _swap_replica(self, i, version, deadline):
        """Queue replica i for a drain-then-rebuild onto ``version`` and
        run rounds until the swap lands (True) or cannot (dead past its
        budget, retired, rolled back, or past ``deadline``: False)."""
        with self._lock:
            if self._states[i] == "live":
                self._states[i] = "draining"
            self._pending_swaps[i] = version
        while True:
            with self._lock:
                if i not in self._pending_swaps:
                    break
                if self._states[i] in ("dead", "retired"):
                    self._pending_swaps.pop(i, None)
                    return False
                if self._clock() > deadline:
                    self._pending_swaps.pop(i, None)
                    if (self._states[i] == "draining"
                            and not self._draining):
                        self._states[i] = "live"
                    return False
            self.step()
        with self._lock:
            return (self._versions[i] == version
                    and self._replicas[i].alive())

    def _advance_swaps(self, finished):
        """Run the queued transitions of replicas that have quiesced
        (idle engine, no dispatched records): a version target rebuilds
        the engine on it (``fleet.deploy`` fault point; a failure rolls
        this replica back to its version), None retires the replica."""
        for i, target in list(self._pending_swaps.items()):
            if self._states[i] in ("dead", "retired"):
                continue
            handle = self._replicas[i]
            if not handle.alive():
                continue      # failover respawns it on its old version
            if handle.load() > 0 or self._replica_outstanding(i):
                continue      # still draining toward the swap
            del self._pending_swaps[i]
            if target is None:
                others = [j for j, s in enumerate(self._states)
                          if j != i and s in ("live", "stalled",
                                              "draining")
                          and self._replicas[j].alive()]
                if not others:
                    # never retire the last alive replica
                    self._states[i] = ("draining" if self._draining
                                       else "live")
                    self._ops_event("scale_down_cancelled", replica=i)
                    continue
                handle.close()
                handle.kill()
                self._states[i] = "retired"
                self._monitor.update(i)
                _metrics.counter("fleet.scale_events").inc(
                    direction="down")
                self._ops_event("scale_down", replica=i)
                continue
            old = self._versions[i]
            self._versions[i] = target
            try:
                fault_point("fleet.deploy")
                handle.respawn()
            except Exception as e:
                # a failed swap must not cost the replica: back onto the
                # old weights
                self._versions[i] = old
                self._ops_event("swap_fail", replica=i, version=target,
                                error=repr(e))
                if handle.alive():
                    # the factory failed: the old engine still serves
                    self._states[i] = ("draining" if self._draining
                                       else "live")
                else:
                    self._respawn(i, e, "live", finished)
                continue
            self._monitor.update(i)
            self._states[i] = "draining" if self._draining else "live"
            self._ops_event("swap", replica=i, version=target, prev=old)

    def _check_canary(self):
        """With enough retirements on both versions, a canary goodput
        below the baseline's by more than ``canary_margin`` stops canary
        routing and queues every canary replica's rollback."""
        canary = self._canary_version
        if canary is None:
            return
        cs = self._version_stats.get(canary)
        bs = self._version_stats.get(self._baseline_version)
        need = self.cfg.canary_min_retired
        if not cs or cs[0] < need or not bs or bs[0] < need:
            return
        c_good, b_good = cs[1] / cs[0], bs[1] / bs[0]
        if c_good >= b_good - self.cfg.canary_margin:
            return
        _metrics.counter("fleet.canary_aborts").inc()
        self._ops_event("canary_abort", version=canary,
                        canary_goodput=round(c_good, 4),
                        baseline_goodput=round(b_good, 4))
        self._canary_version = None
        for i, v in enumerate(list(self._versions)):
            if v == canary and self._states[i] not in ("dead",
                                                       "retired"):
                if self._states[i] == "live":
                    self._states[i] = "draining"
                self._pending_swaps[i] = self._baseline_version

    def _autoscale(self):
        """Backlog with headroom under ``autoscale_max`` spawns a
        baseline replica; slack above the floor queues a graceful
        drain-then-retire of the least loaded. One action per
        ``scale_cooldown_s``; parked during deploys and drains."""
        cfg = self.cfg
        if not cfg.autoscale_max or cfg.autoscale_max <= 0:
            return
        if (self._model is None or self._deploying is not None
                or self._draining):
            return
        now = self._clock()
        if (self._last_scale_t is not None
                and now - self._last_scale_t < cfg.scale_cooldown_s):
            return
        live = [i for i, s in enumerate(self._states) if s == "live"]
        backlog = len(self._pending)
        if backlog > 0 and len(live) < cfg.autoscale_max:
            try:
                fault_point("fleet.scale")
                i = self._spawn_replica(self._baseline_version)
            except Exception as e:
                self._ops_event("scale_up_fail", error=repr(e))
                self._last_scale_t = now
                return
            self._last_scale_t = now
            _metrics.counter("fleet.scale_events").inc(direction="up")
            self._ops_event("scale_up", replica=i, backlog=backlog)
            return
        floor = max(1, cfg.autoscale_min or 1)
        if len(live) <= floor:
            return
        out = backlog + sum(self._replica_outstanding(i) for i in live)
        if out * 2 > (len(live) - 1) * cfg.replica_queue_limit:
            return            # the survivors could not absorb the load
        victims = [i for i in live
                   if self._canary_version is None
                   or self._versions[i] != self._canary_version]
        if self._roles:
            # never retire the last live replica of a role
            victims = [i for i in victims
                       if sum(1 for j in live
                              if self._roles[j] == self._roles[i]) > 1]
        if not victims:
            return
        try:
            fault_point("fleet.scale")
        except Exception as e:
            self._ops_event("scale_down_fail", error=repr(e))
            self._last_scale_t = now
            return
        victim = min(victims,
                     key=lambda i: (self._replicas[i].load(), -i))
        self._states[victim] = "draining"
        self._pending_swaps[victim] = None
        self._last_scale_t = now
        self._ops_event("scale_down_begin", replica=victim,
                        outstanding=out)

    def _spawn_replica(self, version):
        """Grow the fleet by one in-process replica on ``version``. The
        per-replica lists grow before the engine is built (the factory
        reads ``self._versions[i]``) and shrink back if it fails."""
        i = len(self._replicas)
        self._versions.append(version)
        self._states.append("live")
        if self._roles:
            self._roles.append("decode")     # growth adds decode capacity
        try:
            handle = InProcessReplica(self._engine_factory(i),
                                      anomaly_sink=self._sink_for(i))
        except Exception:
            self._versions.pop()
            self._states.pop()
            if self._roles:
                self._roles.pop()
            raise
        self._replicas.append(handle)
        self._budgets.append(self._new_budget())
        self._monitor.add_worker(i)
        self._monitor.update(i)
        return i

    # -- liveness + failover ----------------------------------------------

    def _ping(self, i):
        try:
            fault_point("fleet.heartbeat")
        except Exception:
            return            # a dropped ping: the monitor's age grows
        self._monitor.update(i)

    def _scan_heartbeats(self, finished):
        dead_after = self.cfg.heartbeat_s * self.cfg.heartbeat_dead_factor
        for w, (st, age) in self._monitor.check().items():
            if self._states[w] in ("dead", "retired"):
                continue
            if age > dead_after:
                self._on_replica_failure(
                    w, ReplicaDead(
                        f"replica {w} heartbeat silent {age:.3f}s"),
                    finished)
            elif st == STALLED and self._states[w] == "live":
                self._states[w] = "stalled"
            elif st != STALLED and self._states[w] == "stalled":
                self._states[w] = "live"

    def _on_replica_failure(self, i, exc, finished):
        """Failover: count it, re-route the dead replica's in-flight work
        from the mirror, respawn under the replica's budget, and
        re-dispatch at once."""
        self.failovers += 1
        _metrics.counter("fleet.failovers").inc()
        was = self._states[i]
        self._states[i] = "dead"
        self._replicas[i].kill()
        victims = sorted(
            (self.requests[fid]
             for (rep, _), fid in list(self._by_replica.items())
             if rep == i
             and self.requests[fid].status == "dispatched"),
            key=lambda r: r.id)
        for key in [k for k in self._by_replica if k[0] == i]:
            del self._by_replica[key]
        for rec in victims:
            rec.status = "pending"
            rec.replica = None
            rec.replica_rid = None
            rec.reroutes += 1
            _metrics.counter("fleet.rerouted").inc()
            self._pending.append(rec)
        self._respawn(i, exc, was, finished)
        self._dispatch(finished)

    def _respawn(self, i, exc, prev_state, finished):
        budget = self._budgets[i]
        while True:
            try:
                budget.failure(exc)   # backoff; raises once spent
            except Exception:
                # the budget is spent: this replica stays dead
                if not self._eligible_replicas():
                    self._fail_all(exc, finished)
                    raise
                return False
            try:
                fault_point("fleet.respawn")
                self._replicas[i].respawn()
            except Exception as e:
                exc = e
                continue
            _metrics.counter("fleet.respawns").inc(replica=str(i))
            self._states[i] = ("draining" if prev_state == "draining"
                               or self._draining else "live")
            self._monitor.update(i)
            return True

    def _fail_all(self, exc, finished):
        """No replica left alive: every outstanding request retires
        ``failed`` before the router re-raises."""
        doomed = [r for r in self.requests.values()
                  if r.status in ("pending", "dispatched")]
        self._pending.clear()
        self._by_replica.clear()
        for rec in doomed:
            self._retire(rec, "failed", "fleet_dead", finished)

    # -- record sync ------------------------------------------------------

    def _sync(self, i, report, finished):
        for fin in report["finished"]:
            fid = self._by_replica.pop((i, fin["rid"]), None)
            if fid is None:
                continue
            rec = self.requests[fid]
            if (rec.phase == "prefill" and fin["status"] == "done"
                    and fin["reason"] == "length"
                    and len(fin["tokens"]) < rec.max_new):
                # the prefill leg hit its max_new=1 cap, not the
                # request's own: the handoff, not a retirement
                self._handoff(rec, fin)
                continue
            rec.tokens = list(fin["tokens"])
            rec.status = fin["status"]
            rec.retire_reason = fin["reason"]
            rec.slo_ok = fin["slo_ok"]
            if fin["first_token_t"] is not None:
                rec.first_token_t = fin["first_token_t"]
            rec.done_t = self._clock()
            self._account_version(rec)
            finished.append(rec)
        for inf in report["inflight"]:
            fid = self._by_replica.get((i, inf["rid"]))
            if fid is None:
                continue
            rec = self.requests[fid]
            rec.tokens = list(inf["tokens"])       # the failover mirror
            if inf["first_token_t"] is not None:
                rec.first_token_t = inf["first_token_t"]

    def _handoff(self, rec, fin):
        """The prefill-to-decode hop: the prefill replica produced the
        first token; the rest re-stages on a decode replica through the
        adopt replay failover uses (prompt + [t0], the real max_new, the
        pinned seed and version). A ``fleet.handoff`` fault sends this
        request back to mixed routing."""
        rec.tokens = list(fin["tokens"])           # [t0]
        if fin["first_token_t"] is not None:
            rec.first_token_t = fin["first_token_t"]
        rec.status = "pending"
        rec.replica = None
        rec.replica_rid = None
        try:
            fault_point("fleet.handoff")
            rec.phase = "decode"
            self.handoffs += 1
            _metrics.counter("fleet.handoffs").inc()
        except Exception:
            rec.phase = None
        self._pending.append(rec)

    def _on_replica_anomaly(self, replica, event):
        # the fleet's flight bundle first (evidence before mitigation
        # changes the state), one per anomaly kind per router
        kind = str(event.get("anomaly", "anomaly"))
        with self._lock:
            fresh = kind not in self._flight_dumped
            self._flight_dumped.add(kind)
        if fresh and _flight.recorder() is not None:
            self._flight_fanout(replica, kind, event)
        if event.get("anomaly") in ("goodput_collapse", "ingest_stall"):
            # spare capacity first (the autoscaler's bounds and cooldown
            # apply), then shed expired or low-priority pending work
            with self._lock:
                self._autoscale()
            self.shed_pending(cause=event["anomaly"])

    def _flight_fanout(self, replica, kind, event):
        """One fleet bundle: every replica's RunLog tail, the fleet's
        state and the event ring."""
        run_logs = []
        with self._lock:
            for h in self._replicas:
                eng = getattr(h, "engine", None)
                rl = getattr(eng, "_run_log", None) if eng else None
                if rl is not None:
                    run_logs.append(rl)
            summary = dict(
                states=list(self._states),
                versions=list(self._versions),
                baseline_version=self._baseline_version,
                canary_version=self._canary_version,
                pending=len(self._pending),
                outstanding=self._outstanding(),
                failovers=self.failovers,
                num_replicas=len(self._replicas))
        _flight.dump_bundle(
            reason=kind, run_logs=run_logs,
            config=dict(fleet=summary,
                        fleet_config=dataclasses.asdict(self.cfg)),
            extra=dict(anomaly=event, source_replica=replica))

    def _retire(self, rec, status, why, finished=None, account=True,
                count=True):
        rec.status = status
        rec.retire_reason = why
        rec.done_t = self._clock()
        if account:
            rec.slo_ok = False
        if count:
            _metrics.counter("serve.requests").inc(status=status)
        self._account_version(rec)
        if finished is not None:
            finished.append(rec)

    def _publish(self):
        counts = collections.Counter(self._states)
        g = _metrics.gauge("fleet.replicas")
        for st in ("live", "stalled", "draining", "dead", "retired"):
            g.set(counts.get(st, 0), state=st)
        depth = _metrics.gauge("fleet.dispatch_depth")
        for i in range(len(self._replicas)):
            depth.set(self._replica_outstanding(i)
                      + sum(1 for r in self._pending
                            if r.replica == i), replica=str(i))
