"""Continuous-batching serving engine over the paged KV cache — the
single-engine serving path of ``paddle_tpu/serving/engine.py``.

What is ported:

  * fixed-slot decode steps over all slots, paged KV memory (requests
    own pages, grow one page at a time as they decode, and free them
    when they finish), prefill-on-admit, and chunked prefill (a prompt
    longer than ``prefill_len`` is admitted as ``ceil(len /
    prefill_len)`` fixed-shape ``[1, prefill_len]`` calls);
  * the prefix cache (``ServeConfig.prefix_cache``, on by default):
    admissions map the cached full pages of their prompt read-only into
    their page table and skip the prefill chunks those pages cover; the
    prefill's write floor drops K/V writes below the match; a match that
    ends inside a page copies that page to a private one first
    (copy-on-write); idle cached pages are evicted LRU-first when the
    free list runs dry;
  * per-request sampling (temperature / top-k / top-p / seed, see
    ``serving/sampling.py``): token ``i`` of a request draws from a
    stream keyed by ``(cfg.seed, req.seed, i)`` alone, so a preempted,
    recovered or re-batched request draws the same tokens;
  * recompute preemption: a pool smaller than ``num_slots x
    ceil(max_len / page_size)`` pages is accepted; when every running
    slot needs a page and none is free, the lowest-priority /
    latest-deadline / youngest of them loses its pages and is requeued;
  * bounded admission: priorities, deadlines (a queued request past its
    deadline is shed), a queue limit (over-limit submissions are
    rejected, retriable) and ``cancel``;
  * crash-isolated step recovery: a failed decode step or prefill chunk
    rebuilds the page pools, clears the prefix cache and requeues every
    in-flight request with its prompt + generated tokens; after
    ``step_retries`` consecutive failures every request fails and the
    error is re-raised. Recovery never switches a kernel to its plain
    version.

  * speculative decoding (``ServeConfig.draft``): a draft model (the
    target itself by default, or ``draft_spec`` with its own weights)
    proposes ``spec_k`` tokens per slot in decode-shaped calls, then one
    batched verify call scores every slot's window ``[pending token,
    proposals]`` against the paged cache and draws each position with
    the key the plain path would use, so the emitted tokens are the
    target's own: greedy output equals the spec-off engine's, and a
    sampled request draws the same tokens. The accepted prefix of
    matching proposals plus one target token is emitted; a rejection is
    a length edit. The draft keeps its own pools, indexed by the same
    page table, and every write to the target pools is mirrored there;
  * the accounting: the ``serve.*`` metrics of the reference (see
    ``observability/metrics.py``), SLO classification at retirement
    (``slo_ttft_s``, ``slo_token_latency_s``), ``goodput()``,
    ``slo_stats()``, ``latency_stats()``, ``spec_stats()`` and
    ``reset_stats()``, and with ``ServeConfig.run_log`` a JSONL record
    per step plus the lifecycle events of every request (submitted,
    admitted, prefill_done, first_token, preempted, resumed, requeued,
    retired). None of it reads the device;
  * the hooks the fleet router (``serving/fleet.py``) drives:
    ``adopt`` (a token-exact replay of prompt + tokens with the caller's
    submit, first-token and absolute deadline times and its trace
    context), ``export_inflight`` (the router's failover mirror),
    ``prefix_lookup_depth`` (its affinity probe), ``anomaly_sink`` (the
    watchdog's uplink) and ``replica`` (stamped on every trace event);
  * the live plane: ``ServeConfig.metrics_port`` starts the ``/metrics``
    exporter, ``ServeConfig.watchdog`` the anomaly watchdog (a goodput
    collapse sheds queued load), every trace event feeds the flight
    recorder's ring, and a standalone engine dumps a flight bundle when
    its watchdog fires; ``chunked_prefill=False`` refuses prompts longer
    than ``prefill_len``.

Terminal statuses: done | rejected | shed | cancelled | failed.

Prompt staging (the reference's prompt prefetch): ``submit`` and
``adopt`` stage the replay sequence onto the model's device as
``ceil(len / prefill_len)`` padded ``[1, prefill_len]`` int32 chunks
through a :class:`~paddle_tpu_torch.data.loader.Stager` (on the card:
pinned memory, a copy stream of the stager's own and an event the
prefill's stream waits on, so a client thread's submit never queues the
copy on the stepping thread's stream); a recovery restages prompt +
generated tokens, and retirement drops the chunks. Each prefill call
reads its chunk, ``staged_prefills`` counts them.

The AOT hooks: ``compiled_decode`` and ``compiled_verify`` return the
``torch.export`` program of one decode step and of one speculative
verify over the engine's state shapes (on the card's path: traced on
fake CUDA tensors where there is no card, so the graph's kernel ops can
be inspected on any machine), and ``export_decode`` writes one greedy
step through ``io.save_train_program``'s state-feedback contract. The
scheduler state (page table, lengths, active mask, pending tokens,
sampling knobs) is host numpy, copied to the model's device before each
call's launches; the page pools live on the device and are updated in
place, in the exported programs too.

One re-entrant lock guards the request tables: clients may ``submit``,
``adopt`` or ``cancel`` from their own threads while ``step`` runs, and
the watchdog's mitigation re-enters ``shed_queued`` from inside a step.
A fleet router takes its own lock before an engine's, never after.
"""

import collections
import dataclasses
import itertools
import threading
import time
import typing
import uuid

import numpy as np
import torch

from paddle_tpu_torch import bridge
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.retry import RetryBudget, RetryPolicy
from paddle_tpu_torch.data.loader import Stager
from paddle_tpu_torch.io.inference import (call_with_params, export_program,
                                           save_train_program)
from paddle_tpu_torch.observability import catalog as _catalog
from paddle_tpu_torch.observability import flight as _flight
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import trace as _trace
from paddle_tpu_torch.observability.exporter import start_metrics_server
from paddle_tpu_torch.observability.runlog import RunLog
from paddle_tpu_torch.observability.watchdog import maybe_watchdog
from paddle_tpu_torch.ops.attention import copy_pages
from paddle_tpu_torch.serving.prefix_cache import PrefixCache
from paddle_tpu_torch.serving.sampling import sample
from paddle_tpu_torch.testing.chaos import fault_point

#: the reference's serve.* metrics, registered when an engine is built
_COUNTERS = ("serve.tokens", "serve.requests", "serve.page_stalls",
             "serve.preemptions", "serve.slo_violations", "serve.recoveries",
             "serve.shed", "serve.prefix_hits", "serve.prefix_misses",
             "serve.cow_copies", "serve.spec_proposed", "serve.spec_accepted",
             "serve.spec_rollbacks")
_GAUGES = ("serve.queue_depth", "serve.active_slots", "serve.goodput",
           "serve.pages_shared", "serve.kv_quant_pages")
_HISTOGRAMS = ("serve.ttft_s", "serve.token_latency_s")


@dataclasses.dataclass
class ServeConfig:
    """Defaults are the reference's flag defaults."""
    num_slots: int = 4           # serve_slots
    page_size: int = 16          # serve_page_size
    max_len: int = 256           # per-request cap: prompt + generated
    prefill_len: int = 64        # padded admission prompt length (fixed)
    num_pages: int = None        # None -> num_slots * ceil(max_len/page)
    cache_dtype: typing.Any = torch.float32
    kv_dtype: typing.Any = None  # torch.int8: int8 pages, per-row scales
    temperature: float = 0.0     # default per-request; 0 = greedy
    top_k: int = 0               # default per-request top-k; 0 = off
    top_p: float = 0.0           # default per-request top-p; 0 = off
    seed: int = 0                # the sampling streams' base key
    prefix_cache: bool = True    # serve_prefix_cache
    prefix_pages: int = 0        # max idle cached pages; 0 = pool-bounded
    eos_id: int = None           # default EOS (submit() can override)
    default_max_new: int = 32
    queue_limit: int = 0         # 0 = unbounded queue
    default_deadline_s: float = 0.0   # 0 = no deadline
    step_retries: int = 3        # consecutive failed steps recovered
    run_log: typing.Any = None   # JSONL path, or an open RunLog
    slo_ttft_s: float = 0.0      # 0 = unbounded
    slo_token_latency_s: float = 0.0   # 0 = unbounded
    metrics_port: int = 0        # serve /metrics on this port; 0 = off
    watchdog: typing.Any = None  # True or a WatchdogConfig; None = off
    chunked_prefill: bool = True  # False refuses prompts > prefill_len
    model_version: str = None    # "model_id@version", in slo_stats()
    # speculative decoding (serve_draft, serve_spec_k)
    draft: bool = False
    spec_k: int = 3              # draft proposals per slot per round
    draft_spec: typing.Any = None       # the draft's GPTConfig; None with
    #                                     draft=True: the target drafts
    draft_variables: typing.Any = None  # {"params": reference-layout tree
    #                                     of numpy arrays} (bridge)
    draft_checkpoint: str = None  # else the newest step of this
    #                               CheckpointManager directory, whose
    #                               state is {"params": {name: tensor}}

    def resolve(self):
        if self.draft_spec is not None or self.draft_checkpoint:
            self.draft = True    # an explicit draft model implies draft
        if self.draft:
            enforce(self.spec_k >= 1,
                    f"spec_k={self.spec_k}: speculative decoding needs at "
                    "least one draft proposal per round")
        pages_per_slot = -(-self.max_len // self.page_size)
        if self.num_pages is None:
            self.num_pages = self.num_slots * pages_per_slot
        enforce(self.prefill_len <= self.max_len,
                "prefill_len must not exceed max_len")
        enforce(self.num_pages >= pages_per_slot,
                f"num_pages={self.num_pages} cannot hold even one "
                f"max_len={self.max_len} request ({pages_per_slot} pages "
                f"of {self.page_size}): preemption needs a lone request "
                "to fit")
        enforce(self.kv_dtype in (None, torch.int8),
                f"kv_dtype={self.kv_dtype!r}: expected None or torch.int8")
        return self


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray            # true (unpadded) prompt, int32 [L]
    max_new: int
    eos_id: int = None
    tokens: list = dataclasses.field(default_factory=list)
    status: str = "queued"        # queued -> running -> terminal (done |
    #                               rejected | shed | cancelled | failed)
    slot: int = None
    pages: list = dataclasses.field(default_factory=list)
    # prefix-cache pages mapped read-only into the slot's table; always a
    # contiguous row prefix: table row = shared_pages ++ pages
    shared_pages: list = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0                 # token i draws from (cfg.seed, seed, i)
    submit_t: float = None
    first_token_t: float = None
    done_t: float = None
    preemptions: int = 0
    recoveries: int = 0           # times requeued after a failed step
    retire_reason: str = None     # "eos" | "length" or the terminal cause
    priority: int = 0             # higher admits first, is evicted last
    deadline_t: float = None      # absolute clock() deadline, or None
    retriable: bool = False       # rejected, worth resubmitting
    slo_ok: bool = None           # every configured SLO met at retirement
    spec_tokens: int = 0          # tokens beyond one per target step
    #                               (accepted draft proposals emitted)
    trace_id: str = None          # lifecycle trace id: engine-scoped,
    #                               or the fleet's when adopted with one
    span_id: str = None           # this hop's span in the fleet trace
    parent_span_id: str = None    # the causal parent hop
    device_prompt: typing.Any = None  # staged [1, prefill_len] chunks of
    #                                   the replay sequence
    trace: list = dataclasses.field(default_factory=list)  # (event, t)

    @property
    def output(self):
        """prompt + generated tokens (the generate()-shaped sequence)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


class ServingEngine:
    """submit()/step()/drain() continuous batching for a
    :class:`~paddle_tpu_torch.models.gpt.GPTDecoder`, on the model's
    device."""

    def __init__(self, model, config=None, clock=time.perf_counter,
                 sleep=time.sleep):
        """``sleep`` takes the recovery backoff (0.05 s, doubling with
        each consecutive failure), injectable for tests."""
        self.cfg = (config or ServeConfig()).resolve()
        cfg = self.cfg
        self._model = model.eval()
        self._device = model.device
        self._clock = clock
        self.version = cfg.model_version
        self._pages_per_slot = -(-cfg.max_len // cfg.page_size)
        self._caches = self._new_caches()
        # speculation: the draft keeps its own pools with the target's page
        # count and size, so one page table indexes both
        self._spec_on = bool(cfg.draft)
        self._draft_model = self._resolve_draft() if self._spec_on else None
        self._draft_caches = (self._new_caches(self._draft_model)
                              if self._spec_on else None)
        s = cfg.num_slots
        self._page_table = np.zeros((s, self._pages_per_slot), np.int32)
        self._lengths = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._last_tokens = np.zeros(s, np.int32)
        # per-slot sampling knobs, set on admission
        self._temps = np.zeros(s, np.float32)
        self._top_ks = np.zeros(s, np.int64)
        self._top_ps = np.zeros(s, np.float32)
        self._seeds = np.zeros(s, np.int64)
        self._gen_counts = np.zeros(s, np.int64)
        self._free_slots = list(range(s))
        self._free_pages = collections.deque(range(cfg.num_pages))
        self._prefix_cache = (
            PrefixCache(cfg.page_size, max_idle_pages=cfg.prefix_pages)
            if cfg.prefix_cache else None)
        self._lock = threading.RLock()
        self._queue = collections.deque()
        self._running = {}
        self.requests = {}
        self._ids = itertools.count()
        self._retry_budget = RetryBudget(
            RetryPolicy(max_attempts=cfg.step_retries + 1, sleep=sleep),
            "serve.step")
        self.decode_steps = 0
        self.prefill_calls = 0
        self.staged_prefills = 0      # prefill calls that read a staged
        #                               chunk
        # host-to-device prompt staging
        self._stager = Stager(self._device)
        # the reference's serve.* counters, kept as attributes (the prefix
        # cache's own are read through the properties below)
        self.prefill_tokens_skipped = 0   # covered by prefix-cache hits
        self.cow_copies = 0
        self.preemptions = 0
        self.recoveries = 0
        self.spec_proposed = 0        # draft tokens offered to verify
        self.spec_accepted = 0        # proposals the target confirmed
        self.spec_rollbacks = 0       # proposals rejected (a length edit)
        self.spec_rounds = 0          # speculative rounds run
        self.spec_slot_rounds = 0     # slots that took part, summed
        self.target_steps = 0         # target-model steps (decode or
        #                               verify)
        self._step_no = 0
        self.anomaly_sink = None      # the fleet router's watchdog uplink
        self.replica = None           # fleet replica index, stamped on
        #                               every trace event once set
        self._run_log = None
        self._own_run_log = False
        if cfg.run_log:
            self._own_run_log = isinstance(cfg.run_log, str)
            self._run_log = (RunLog(cfg.run_log) if self._own_run_log
                             else cfg.run_log)
            # the fleet-trace merge rebases this log's clock with it
            _trace.write_anchor(self._run_log,
                                model_version=cfg.model_version)
        # listed (with help text) in a snapshot and on /metrics from the
        # start, as in the reference
        _catalog.preregister(_COUNTERS + _GAUGES + _HISTOGRAMS
                             + ("jit.retraces",))
        self._retired = 0
        self._retired_ok = 0
        self._viol_base = dict(
            _metrics.counter("serve.slo_violations").snapshot())
        self._trace_run = uuid.uuid4().hex[:8]
        self._metrics_server = start_metrics_server(cfg.metrics_port)
        self._watchdog = maybe_watchdog(cfg.watchdog, run_log=self._run_log,
                                        action=self._on_anomaly)

    def _cache_count(self, name):
        return getattr(self._prefix_cache, name) if self._prefix_cache else 0

    @property
    def prefix_hits(self):
        """Full prompt pages served from the prefix cache."""
        return self._cache_count("hits")

    @property
    def prefix_misses(self):
        """Full prompt pages not served (a failed match misses them all)."""
        return self._cache_count("misses")

    @property
    def evictions(self):
        return self._cache_count("evictions")

    def _new_caches(self, model=None):
        """Page pools for ``model`` (default: the target)."""
        cfg = self.cfg
        return (model or self._model).init_paged_caches(
            cfg.num_pages, cfg.page_size, dtype=cfg.cache_dtype,
            kv_dtype=cfg.kv_dtype)

    def _resolve_draft(self):
        """The draft model. No ``draft_spec``: the target drafts for
        itself (the plumbing probe). Else a
        ``GPTDecoder(draft_spec)`` on the target's device with the weights
        of ``cfg.draft_variables``, else of the newest healthy step under
        ``cfg.draft_checkpoint`` (the verified restore; a directory with
        no step raises), else drawn from ``cfg.seed``."""
        cfg = self.cfg
        if cfg.draft_spec is None:
            return self._model
        from paddle_tpu_torch.io.checkpoint import CheckpointManager
        from paddle_tpu_torch.models.gpt import GPTDecoder
        draft = GPTDecoder(cfg.draft_spec, device=self._device,
                           seed=cfg.seed)
        if cfg.draft_variables is not None:
            bridge.load_params(draft, cfg.draft_variables["params"])
        elif cfg.draft_checkpoint:
            named = dict(draft.named_parameters())
            state, _ = CheckpointManager(cfg.draft_checkpoint).restore(
                {"params": named})
            enforce(state is not None,
                    f"draft_checkpoint={cfg.draft_checkpoint!r} holds no "
                    "restorable step")
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(state["params"][name])
        return draft.eval()

    def _dev(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self._device)

    # --- public API ---

    def submit(self, prompt, max_new=None, eos_id=None, deadline_s=None,
               priority=0, temperature=None, top_k=None, top_p=None,
               seed=None):
        """Queue a prompt (at most ``max_len`` tokens; longer than
        ``prefill_len`` is admitted chunk by chunk); returns the request
        id. ``deadline_s`` (None: ``cfg.default_deadline_s``, 0 there
        meaning none) sets an absolute deadline past which a queued
        request is shed; a non-positive explicit value is rejected as
        infeasible. ``priority`` (higher first) orders admission and
        inverts the preemption victim choice. With ``cfg.queue_limit``
        set, an over-limit submission is rejected (``retriable``): check
        ``engine.requests[rid].status``. ``temperature`` / ``top_k`` /
        ``top_p`` default to the config's; ``seed`` (None: derived from
        ``cfg.seed`` and the id) pins the request's sampling stream."""
        cfg = self.cfg
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = max_new if max_new is not None else cfg.default_max_new
        self._check_lengths(prompt, max_new)
        with self._lock:
            return self._submit(prompt, max_new, eos_id, deadline_s,
                                priority, temperature, top_k, top_p, seed)

    def _check_lengths(self, prompt, max_new):
        """A prompt of at most ``max_len`` tokens (``prefill_len`` with
        ``chunked_prefill`` off) whose ``max_new`` tokens fit too."""
        cfg = self.cfg
        cap = cfg.max_len if cfg.chunked_prefill else cfg.prefill_len
        enforce(1 <= prompt.size <= cap,
                f"prompt length {prompt.size} not in [1, {cap}]"
                + ("" if cfg.chunked_prefill
                   else " (prefill_len; chunked_prefill is off)"))
        enforce(prompt.size + max_new <= cfg.max_len,
                f"prompt {prompt.size} + max_new {max_new} exceeds "
                f"max_len {cfg.max_len}")

    def _submit(self, prompt, max_new, eos_id, deadline_s, priority,
                temperature, top_k, top_p, seed):
        cfg = self.cfg
        req = Request(id=next(self._ids), prompt=prompt, max_new=max_new,
                      eos_id=eos_id if eos_id is not None else cfg.eos_id,
                      priority=int(priority))
        self._resolve_sampling(req, temperature, top_k, top_p, seed)
        req.trace_id = f"{self._trace_run}/{req.id}"
        self.requests[req.id] = req
        extra = {}
        if priority:
            extra["priority"] = int(priority)
        if deadline_s is not None:
            extra["deadline_s"] = float(deadline_s)
        req.submit_t = self._trace_event(req, "submitted",
                                         prompt_len=int(prompt.size),
                                         max_new=int(max_new), **extra)
        _metrics.counter("serve.requests").inc(status="submitted")
        if deadline_s is None and cfg.default_deadline_s > 0:
            deadline_s = cfg.default_deadline_s
        if deadline_s is not None:
            if deadline_s <= 0:
                self._reject(req, "infeasible_deadline")
                return req.id
            req.deadline_t = req.submit_t + float(deadline_s)
        if cfg.queue_limit and len(self._queue) >= cfg.queue_limit:
            self._reject(req, "queue_full")
            return req.id
        req.device_prompt = self._stage_chunks(prompt)
        self._queue.append(req)
        _metrics.gauge("serve.queue_depth").set(len(self._queue))
        return req.id

    def adopt(self, prompt, tokens=(), max_new=None, eos_id=None,
              priority=0, deadline_t=None, submit_t=None,
              first_token_t=None, origin="fleet", temperature=None,
              top_k=None, top_p=None, seed=None, trace=None):
        """The fleet router's dispatch and failover entry: queue a request
        whose generation may already be ``tokens`` deep. ``submit_t``,
        ``first_token_t`` and the absolute ``deadline_t`` are kept as
        given, so TTFT and SLO accounting land on the engine that
        completes the request. Admission replays prompt + tokens as a
        step recovery does, so a greedy adoption finishes token-exact.
        No ``queue_limit`` check: the router bounds its own dispatch, and
        a failover must not be rejected. ``trace`` is the router's
        :class:`~paddle_tpu_torch.observability.trace.TraceContext` wire
        dict: the request keeps its trace id across the hop. Returns the
        request id."""
        cfg = self.cfg
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tokens = [int(t) for t in tokens]
        max_new = max_new if max_new is not None else cfg.default_max_new
        self._check_lengths(prompt, max_new)
        enforce(len(tokens) <= max_new,
                f"adopted with {len(tokens)} tokens > max_new {max_new}")
        with self._lock:
            req = Request(id=next(self._ids), prompt=prompt,
                          max_new=max_new,
                          eos_id=eos_id if eos_id is not None
                          else cfg.eos_id,
                          priority=int(priority))
            self._resolve_sampling(req, temperature, top_k, top_p, seed)
            req.tokens = tokens
            req.deadline_t = deadline_t
            req.first_token_t = first_token_t
            ctx = _trace.TraceContext.from_wire(trace) if trace else None
            if ctx is not None:
                req.trace_id = ctx.trace_id
                req.span_id = ctx.span_id
                req.parent_span_id = ctx.parent_span_id
            else:
                req.trace_id = f"{self._trace_run}/{req.id}"
            self.requests[req.id] = req
            t = self._trace_event(req, "adopted", origin=origin,
                                  prompt_len=int(prompt.size),
                                  tokens_kept=len(tokens))
            req.submit_t = submit_t if submit_t is not None else t
            _metrics.counter("serve.requests").inc(status="adopted")
            req.device_prompt = self._stage_chunks(req.output if tokens
                                                   else prompt)
            self._queue.append(req)
            _metrics.gauge("serve.queue_depth").set(len(self._queue))
            return req.id

    def export_inflight(self):
        """Every non-terminal request's host state, queued ones first
        then running ones by id: the router's failover mirror, read each
        healthy round (no device read)."""
        with self._lock:
            live = list(self._queue) + sorted(self._running.values(),
                                              key=lambda r: r.id)
            return [dict(rid=req.id, status=req.status,
                         tokens=list(req.tokens),
                         prompt_len=int(req.prompt.size),
                         priority=req.priority, submit_t=req.submit_t,
                         first_token_t=req.first_token_t,
                         deadline_t=req.deadline_t) for req in live]

    def prefix_lookup_depth(self, prompt):
        """Leading full prompt pages the prefix cache holds: the fleet
        router's affinity probe (read-only)."""
        with self._lock:
            if self._prefix_cache is None:
                return 0
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            return self._prefix_cache.lookup_depth(prompt)

    def cancel(self, request_id):
        """Client-initiated cancellation. A queued request leaves the
        queue; a running one frees its slot and pages at once. Returns
        False when the id is unknown or already terminal."""
        with self._lock:
            req = self.requests.get(request_id)
            if req is None or req.status not in ("queued", "running"):
                return False
            if req.status == "queued":
                self._queue.remove(req)
            else:
                self._free_slot_state(req)
            # the client walked away: not counted against goodput
            self._retire_terminal(req, "cancelled", "cancelled",
                                  account=False)
            _metrics.gauge("serve.queue_depth").set(len(self._queue))
            _metrics.gauge("serve.active_slots").set(len(self._running))
            return True

    def step(self):
        """One scheduling round: shed expired queued requests, admit
        queued prompts into free slots (prefill-on-admit), grow page
        tables where the next token opens a page (preempting while every
        running slot is stalled), run one decode step over all slots (or,
        with speculation, one draft-and-verify round), and retire
        requests that hit EOS or their token budget. Returns the requests
        finished this round."""
        with self._lock:
            return self._step()

    @torch.inference_mode()
    def _step(self):
        t0 = self._clock()
        finished = []
        if not self._caches:
            # a spent recovery budget left the pools unbuilt
            self._build_pools()
        self._shed_expired(finished)
        self._admit(finished)
        stalled = self._grow_pages()
        while stalled and not self._active.any():
            # pool deadlock: every live slot needs a page and none is
            # free; the lowest-value stalled request gives its pages back
            victim = min((self._running[s] for s in stalled),
                         key=self._victim_key)
            self._preempt(victim)
            stalled = self._grow_pages()
        new_tokens = 0
        toks = spec = None
        spec_proposed = spec_accepted = None
        if self._active.any():
            use_spec = self._spec_on
            if use_spec:
                try:
                    fault_point("spec.verify")
                except Exception:
                    # a verify fault degrades this round to one plain
                    # decode step, which draws the same tokens
                    use_spec = False
            try:
                fault_point("serve.step")
                if use_spec:
                    spec = self._spec_round()
                else:
                    toks = self._decode()
            except Exception as e:
                self._recover("serve.step", e)
        if spec is not None:
            # per slot: accept the leading run of proposals equal to the
            # target's own draws and emit accepted + 1 of those draws;
            # rejected rows stay written past the length, to be
            # overwritten later
            self._retry_budget.success()
            self.spec_rounds += 1
            self.target_steps += 1
            dt = self._clock() - t0
            lat = _metrics.histogram("serve.token_latency_s")
            sampled, props, win = spec
            spec_proposed = spec_accepted = 0
            for slot, req in list(self._running.items()):
                if not self._active[slot]:
                    continue                   # page-stalled this round
                w = int(win[slot])
                self.spec_slot_rounds += 1
                a = 0
                while a < w - 1 and props[slot, a] == sampled[slot, a]:
                    a += 1
                m = a + 1                      # tokens safe to emit
                spec_proposed += w - 1
                spec_accepted += a
                emitted = 0
                for j in range(m):
                    emitted += 1
                    lat.observe(dt / m)
                    if self._emit(req, slot, int(sampled[slot, j]),
                                  finished):
                        break
                new_tokens += emitted
                req.spec_tokens += emitted - 1
            self.spec_proposed += spec_proposed
            self.spec_accepted += spec_accepted
            self.spec_rollbacks += spec_proposed - spec_accepted
            _metrics.counter("serve.spec_proposed").inc(spec_proposed)
            _metrics.counter("serve.spec_accepted").inc(spec_accepted)
            _metrics.counter("serve.spec_rollbacks").inc(
                spec_proposed - spec_accepted)
        elif toks is not None:
            self._retry_budget.success()
            self.decode_steps += 1
            self.target_steps += 1
            dt = self._clock() - t0
            lat = _metrics.histogram("serve.token_latency_s")
            for slot, req in list(self._running.items()):
                if not self._active[slot]:
                    continue                   # page-stalled this round
                lat.observe(dt)
                new_tokens += 1
                self._emit(req, slot, int(toks[slot]), finished)
        _metrics.counter("serve.tokens").inc(new_tokens)
        _metrics.gauge("serve.active_slots").set(len(self._running))
        _metrics.gauge("serve.queue_depth").set(len(self._queue))
        if self.cfg.kv_dtype is not None:
            _metrics.gauge("serve.kv_quant_pages").set(
                self.cfg.num_pages - len(self._free_pages))
        wall_s = self._clock() - t0
        if self._run_log is not None:
            rec = {"phase": "serve", "step": self._step_no,
                   "wall_s": wall_s, "new_tokens": new_tokens,
                   "active": len(self._running),
                   "queue_depth": len(self._queue),
                   "goodput": round(self.goodput(), 4)}
            if spec_proposed is not None:
                rec["spec_proposed"] = spec_proposed
                rec["spec_accepted"] = spec_accepted
            self._run_log.write(rec)
        if self._watchdog is not None:
            self._watchdog.tick(self._step_no, wall_s=wall_s,
                                goodput=self.goodput(),
                                retired=self._retired)
        self._step_no += 1
        return finished

    def _emit(self, req, slot, tok, finished):
        """Append one generated token, whose K/V the step just cached;
        retire the request when it is done. Returns True if it was."""
        self._lengths[slot] += 1
        req.tokens.append(tok)
        self._gen_counts[slot] += 1        # the next draw's index
        self._last_tokens[slot] = tok
        reason = self._done_reason(req, tok)
        if reason:
            self._release(req, finished, reason)
        return bool(reason)

    def drain(self, max_steps=100000):
        """Run step() until every submitted request is terminal; returns
        the requests finished (or shed) in order."""
        out = []
        # the lock is released between rounds, so client threads can
        # still submit or cancel while the drain runs
        for _ in range(max_steps):
            with self._lock:
                more = bool(self._queue or self._running)
            if not more:
                break
            out.extend(self.step())
        else:
            raise RuntimeError(
                f"drain: {len(self._queue)} queued / {len(self._running)} "
                f"running requests left after {max_steps} steps")
        if self._run_log is not None:
            snap = _metrics.snapshot()
            self._run_log.write({"final": True, "phase": "serve",
                                 "kv_dtype": self.kv_dtype_name(),
                                 "kv_pool_bytes": self.kv_pool_bytes(),
                                 "counters": snap.get("counters", {}),
                                 "gauges": snap.get("gauges", {}),
                                 "slo": self.slo_stats()})
        return out

    def close(self):
        """Stop the exporter and close the run log the engine opened (one
        it was handed stays open)."""
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._run_log is not None and self._own_run_log:
            self._run_log.close()
        self._run_log = None

    def shed_queued(self, cause="overload"):
        """Load shedding: shed every expired queued request; when none is
        expired, the single lowest-priority / latest-deadline one.
        Returns the shed ids. The watchdog's mitigation."""
        with self._lock:
            now = self._clock()
            shed = [(r, "deadline_expired") for r in self._queue
                    if r.deadline_t is not None and now > r.deadline_t]
            if not shed and self._queue:
                shed = [(min(self._queue, key=self._victim_key), cause)]
            for req, why in shed:
                self._queue.remove(req)
                _metrics.counter("serve.shed").inc(cause=cause)
                self._retire_terminal(req, "shed", why)
            _metrics.gauge("serve.queue_depth").set(len(self._queue))
            return [req.id for req, _ in shed]

    def _on_anomaly(self, event):
        """The watchdog's action: note the anomaly in the flight ring; a
        goodput collapse or ingest stall sheds queued load; then the
        event goes up ``anomaly_sink`` when a fleet router owns this
        engine (the router writes the fleet's flight bundle), else this
        engine writes its own bundle."""
        fl = _flight.recorder()
        if fl is not None:
            fl.note_event("anomaly", **{k: v for k, v in event.items()
                                        if k not in ("event", "t")})
        if event.get("anomaly") in ("goodput_collapse", "ingest_stall"):
            self.shed_queued(cause=event["anomaly"])
        if self.anomaly_sink is not None:
            self.anomaly_sink(event)
        elif fl is not None:
            _flight.dump_bundle(
                reason=str(event.get("anomaly", "anomaly")),
                run_logs=(self._run_log,) if self._run_log else (),
                config=dict(serve_config=self.config_summary(),
                            model_version=self.version),
                extra=dict(anomaly=event))

    def config_summary(self):
        """The ServeConfig's fields as a dict (the flight bundle's config
        section; non-scalar values are written as their repr)."""
        return {f.name: getattr(self.cfg, f.name)
                for f in dataclasses.fields(self.cfg)}

    # --- AOT hooks (ref: engine.py:948-1043) ---

    def _aot_device(self, device):
        return torch.device(device) if device is not None else self._device

    def _params_tree(self):
        return bridge.param_tree(self._model)

    def _knob_arrays(self):
        return (self._temps, self._top_ks, self._top_ps, self._seeds,
                self._gen_counts)

    def compiled_decode(self, device=None):
        """The ``torch.export`` program of one decode step over the
        engine's state shapes, with the sampling knobs (ref:
        ``compiled_decode``): inputs ``(params, pools, tokens, page_table,
        lengths, active, temps, top_ks, top_ps, seeds, counts)``, flat in
        the JAX package's order; output the drawn tokens ``[S]`` (a greedy
        row, temperature 0, takes the argmax). ``device`` (default the
        engine's): ``"cuda"`` traces the card path, on fake CUDA tensors
        where there is no card; ``"cpu"`` the plain versions. Nothing
        runs and no state changes."""
        s = self.cfg.num_slots

        def step(params, caches, tokens, page_table, lengths, active,
                 *knobs):
            logits, _ = call_with_params(
                self._model, params,
                lambda m, *a: m.paged_decode_step(*a), tokens, caches,
                page_table, lengths, active)
            return self._draw(logits, knobs)

        return export_program(step, (
            self._params_tree(), self._caches, np.zeros(s, np.int32),
            self._page_table, np.zeros(s, np.int32), np.zeros(s, bool),
            *self._knob_arrays()), self._aot_device(device))

    def compiled_verify(self, device=None):
        """The ``torch.export`` program of one speculative verify (ref:
        ``compiled_verify``; needs ``draft=True``): ``paged_verify_chunk``
        of the ``[S, spec_k + 1]`` window and the ``spec_k + 1``
        ``verify_head`` calls and draws of ``_spec_round``, from the
        stacked window to the draws ``[S, spec_k + 1]``. Inputs ``(params,
        pools, window, starts, win_lengths, page_table, temps, top_ks,
        top_ps, seeds, counts)``. A live verify reads ``starts`` on the
        host to pick each row's attention branch; a trace cannot, so the
        program is the continuation branch, ``starts >= 1`` in every
        row, as ``_spec_round`` arranges (it starts a row with no window
        at 1). ``device`` as :meth:`compiled_decode`'s."""
        enforce(self._spec_on, "compiled_verify() needs draft=True")
        s, w = self.cfg.num_slots, self.cfg.spec_k + 1
        continuation = [True] * s

        def verify(m, window, starts, win_lengths, caches, page_table,
                   knobs):
            hidden, _ = m.paged_verify_chunk(window, starts, win_lengths,
                                             caches, page_table,
                                             chunked=continuation)
            return torch.stack([self._draw(m.verify_head(hidden[:, i]),
                                           knobs, i) for i in range(w)],
                               dim=1)

        def step(params, caches, window, starts, win_lengths, page_table,
                 *knobs):
            return call_with_params(self._model, params, verify, window,
                                    starts, win_lengths, caches, page_table,
                                    knobs)

        return export_program(step, (
            self._params_tree(), self._caches, np.zeros((s, w), np.int32),
            np.ones(s, np.int32), np.ones(s, np.int32), self._page_table,
            *self._knob_arrays()), self._aot_device(device))

    def export_decode(self, path):
        """Export ONE greedy serve step through
        ``io.inference.save_train_program``'s state-feedback contract
        (ref: ``export_decode``): state ``(params, page pools)``, batch
        ``(tokens, page_table, lengths, active)``, outputs ``[next tokens
        int32, *flat(state)]``, so a loop with no model code runs the
        continuous-batching decode, the host only rewriting the small
        batch inputs between steps. The program writes the K/V of the
        step into the pools **in place**, as the engine does (no pool
        copy a step): ``signature.json``'s ``inplace`` lists the pool
        inputs, and the outputs that ``feedback`` pairs with them are
        those same tensors. Exported for the engine's device, from the
        live state (the pools as they are now go to ``params.bin``)."""
        s = self.cfg.num_slots

        def step(state, tokens, page_table, lengths, active):
            params, caches = state
            logits, caches = call_with_params(
                self._model, params,
                lambda m, *a: m.paged_decode_step(*a), tokens, caches,
                page_table, lengths, active)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return nxt, (params, caches)

        example = tuple(self._dev(a) for a in (
            np.zeros(s, np.int32), self._page_table, np.zeros(s, np.int32),
            np.zeros(s, bool)))
        return save_train_program(path, step,
                                  (self._params_tree(), self._caches),
                                  example)

    def kv_dtype_name(self):
        """"int8" for a quantized page pool, else "f32" (the reference's
        label, whatever the float dtype)."""
        return "int8" if self.cfg.kv_dtype is not None else "f32"

    def kv_pool_bytes(self):
        """Bytes of the target's page pools (the draft's are not
        counted, as in the reference)."""
        return sum(t.numel() * t.element_size()
                   for pool in self._caches for t in pool.values())

    # --- accounting ---

    def spec_stats(self):
        """Speculation accounting. Each active slot costs one target-model
        step a round (decode or verify); a slot's speculative round emits
        1 + accepted tokens."""
        prop, acc = self.spec_proposed, self.spec_accepted
        sr = self.spec_slot_rounds
        return {
            "enabled": self._spec_on,
            "spec_k": self.cfg.spec_k if self._spec_on else 0,
            "rounds": self.spec_rounds,
            "target_steps": self.target_steps,
            "proposed": prop,
            "accepted": acc,
            "rollbacks": self.spec_rollbacks,
            "acceptance_rate": round(acc / prop, 4) if prop else None,
            "tokens_per_target_step":
                round((sr + acc) / sr, 4) if sr else None}

    def goodput(self):
        """Fraction of retired requests that met every configured SLO
        (1.0 before the first retirement)."""
        return self._retired_ok / self._retired if self._retired else 1.0

    def slo_stats(self):
        """Goodput, the targets, and SLO violations since construction or
        :meth:`reset_stats`."""
        viol = _metrics.counter("serve.slo_violations").snapshot()
        delta = {k.split("=", 1)[1]: v - self._viol_base.get(k, 0)
                 for k, v in viol.items()}
        return {"goodput": round(self.goodput(), 4),
                "retired": self._retired,
                "version": self.version,
                "slo_ttft_s": self.cfg.slo_ttft_s or None,
                "slo_token_latency_s": self.cfg.slo_token_latency_s or None,
                "violations": {"ttft": delta.get("ttft", 0),
                               "token_latency":
                                   delta.get("token_latency", 0)}}

    def reset_stats(self):
        """Zero the serve latency histograms (process-wide, as in the
        reference), this engine's SLO tallies and its speculation
        counters, so a warm-up stays out of a timed window."""
        for name in _HISTOGRAMS:
            _metrics.histogram(name).reset()
        self.spec_proposed = self.spec_accepted = 0
        self.spec_rollbacks = self.spec_rounds = 0
        self.spec_slot_rounds = self.target_steps = 0
        self._retired = self._retired_ok = 0
        self._viol_base = dict(
            _metrics.counter("serve.slo_violations").snapshot())
        _metrics.gauge("serve.goodput").set(1.0)

    def latency_stats(self):
        """``{"ttft_ms": {p50, p95, n}, "token_ms": {...}}`` from the
        registry's histograms."""
        out = {}
        for name, hist in (("ttft_ms", "serve.ttft_s"),
                           ("token_ms", "serve.token_latency_s")):
            st = _metrics.histogram(hist).stats()
            if st:
                out[name] = {"p50": round(st["p50"] * 1e3, 3),
                             "p95": round(st["p95"] * 1e3, 3),
                             "n": st["count"]}
        return out

    def _trace_event(self, req, event, **extra):
        """One lifecycle event: a clock read, an append to ``req.trace``,
        with a run log one JSONL record, and with the flight recorder on
        an append to its ring. Returns the time."""
        t = self._clock()
        req.trace.append((event, t))
        fl = _flight.recorder()
        if self._run_log is None and fl is None:
            return t
        rec = {"event": event, "req": req.id, "trace": req.trace_id,
               "t": t, "at_step": self._step_no}
        if req.slot is not None:
            rec["slot"] = req.slot
        if self.version is not None:
            rec["version"] = self.version
        if self.replica is not None:
            rec["replica"] = self.replica
        if req.span_id is not None:
            rec["span"] = req.span_id
            rec["parent_span"] = req.parent_span_id
        rec.update(extra)
        if self._run_log is not None:
            self._run_log.write(rec)
        if fl is not None:           # a deque append: no I/O, no sync
            fl.note(rec)
        return t

    # --- device calls ---

    def _knobs(self, temps, *rest):
        """The sampling knobs on the device, or None when every row is
        greedy (read from the host arrays: no device read). Called before
        the model's launches are queued, since a host-to-device copy
        waits for the work queued before it."""
        if not (temps > 0).any():
            return None
        return tuple(self._dev(a) for a in (temps,) + rest)

    def _draw(self, logits, knobs, offset=0):
        """Tokens of logits ``[B, V]`` on the device: plain argmax when
        every row is greedy, else :func:`sample` with each row's count
        moved on by ``offset`` (the draw ``offset`` tokens ahead)."""
        if knobs is None:
            return torch.argmax(logits, dim=-1)
        temps, top_ks, top_ps, seeds, counts = knobs
        return sample(logits, temps, top_ks, top_ps, seeds, counts + offset,
                      base_seed=self.cfg.seed)

    def _tokens(self, logits, knobs):
        """:meth:`_draw` as host numpy: the one sync per call, since the
        scheduler needs the tokens."""
        return self._draw(logits, knobs).cpu().numpy()

    def _decode(self):
        knobs = self._knobs(self._temps, self._top_ks, self._top_ps,
                            self._seeds, self._gen_counts)
        logits, self._caches = self._model.paged_decode_step(
            self._dev(self._last_tokens), self._caches,
            self._dev(self._page_table), self._dev(self._lengths),
            self._dev(self._active))
        return self._tokens(logits, knobs)

    def _spec_round(self):
        """One speculative round (ref: ``_spec_round``). Window sizing:
        ``win[slot] = min(spec_k + 1, tokens left)``, with pages taken for
        the window; in a pool famine the window shrinks to the pages the
        slot owns, never below 1 (``_grow_pages`` made the pending
        position writable). The draft then makes ``spec_k`` decode-shaped
        calls with ``lengths + i``, ``counts + i`` and ``active & (win >
        i + 1)``, each proposal fed back on the device; one verify call
        scores the window ``[pending token, proposals]`` and position
        ``i`` is drawn with count ``counts + i``, the key the plain path
        would use. Every host array goes to the card before the first
        launch, and the round reads the device once: proposals and draws
        together. Returns host ``(draws [S, W], proposals [S, K], win
        [S])``."""
        cfg = self.cfg
        ps = cfg.page_size
        k = cfg.spec_k
        win = np.zeros(cfg.num_slots, np.int32)
        for slot, req in self._running.items():
            if not self._active[slot]:
                continue                   # page-stalled this round
            w = min(k + 1, req.max_new - len(req.tokens))
            ln = int(self._lengths[slot])
            while w > 1:
                owned = len(req.shared_pages) + len(req.pages)
                if (ln + w - 1) // ps < owned:
                    break                  # the window is covered
                page = self._alloc_page()
                if page is None:
                    w = owned * ps - ln    # famine: what the slot owns
                    break
                req.pages.append(page)
                self._page_table[slot, owned] = page
            win[slot] = w
        knobs = self._knobs(self._temps, self._top_ks, self._top_ps,
                            self._seeds, self._gen_counts)
        table = self._dev(self._page_table)
        lengths = self._dev(self._lengths)
        active = self._dev(self._active)
        win_dev = self._dev(win)
        pending = self._dev(self._last_tokens).long()
        # a row with no window writes nothing and its draws are dropped;
        # starting it at 1 or later keeps every row on the continuation
        # branch (no first-chunk flash launch in verify)
        starts = self._host(np.maximum(self._lengths, 1))
        tok, props = pending, []
        for i in range(k):
            logits, self._draft_caches = self._draft_model.paged_decode_step(
                tok, self._draft_caches, table, lengths + i,
                active & (win_dev > i + 1))
            tok = self._draw(logits, knobs, i)
            props.append(tok)
        hidden, self._caches = self._model.paged_verify_chunk(
            torch.stack([pending] + props, dim=1), starts, win_dev,
            self._caches, table)
        draws = [self._draw(self._model.verify_head(hidden[:, i]), knobs, i)
                 for i in range(k + 1)]
        out = torch.stack(props + draws, dim=1).cpu().numpy()
        return out[:, k:], out[:, :k], win

    def _host(self, array):
        """A host tensor the model moves to the card without waiting on
        the queue: pinned when the model is on a card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self._device.type == "cuda" else t

    def _stage_chunks(self, seq):
        """``seq`` staged on the device as ``ceil(len / prefill_len)``
        zero-padded ``[1, prefill_len]`` int32 chunks. Staging more than
        an admission needs is harmless: each prefill call drops the rows
        past its chunk length, so a preempted request (tokens dropped)
        reuses its chunks."""
        lp = self.cfg.prefill_len
        seq = np.asarray(seq, np.int32).reshape(-1)
        n = max(1, -(-seq.size // lp))
        padded = np.zeros((n * lp,), np.int32)
        padded[:seq.size] = seq
        return [self._stager.place(padded[i * lp:(i + 1) * lp][None, :])
                for i in range(n)]

    def _prefill_chunk(self, req, start, clen, floor):
        cfg = self.cfg
        # a chunk with no row at or above the floor would send every
        # write to the first row's page, which may be a shared one
        enforce(start + clen > floor, f"prefill chunk [{start}, "
                f"{start + clen}) lies wholly below its write floor {floor}")
        # starts are whole chunks: chunk start // prefill_len, waited for
        # on this thread's stream
        window = self._stager.ready(
            req.device_prompt[start // cfg.prefill_len])
        self.staged_prefills += 1
        knobs = self._knobs(*self._sampling_rows(req))
        args = (window, torch.tensor([start], dtype=torch.int32),
                torch.tensor([clen], dtype=torch.int32))
        row = self._dev(self._page_table[req.slot][None, :])
        floors = self._dev(np.asarray([floor], np.int32))
        logits, self._caches = self._model.paged_prefill_chunk(
            *args, self._caches, row, write_floor=floors)
        if self._spec_on:
            # the same chunk into the draft pools, with the same floor, so
            # the first round finds the draft's cache warm
            _, self._draft_caches = self._draft_model.paged_prefill_chunk(
                *args, self._draft_caches, row, write_floor=floors)
        self.prefill_calls += 1
        return int(self._tokens(logits, knobs)[0])

    # --- page allocation + prefix cache ---

    def _pages_available(self):
        """Pages an admission could obtain now: the free list plus idle
        (refcount-zero) prefix-cache pages."""
        n = len(self._free_pages)
        if self._prefix_cache is not None:
            n += self._prefix_cache.evictable()
        return n

    def _alloc_page(self):
        """One free page id, evicting the least-recently-released idle
        cached page when the free list is dry; None when nothing is
        reclaimable."""
        if self._free_pages:
            return self._free_pages.popleft()
        if self._prefix_cache is not None:
            for page in self._prefix_cache.evict(1):
                return page
        return None

    def _return_pages(self, req):
        """Private pages to the free list; shared pages back to the cache
        (they stay cached for later hits unless ``prefix_pages`` trims
        them)."""
        self._free_pages.extend(req.pages)
        req.pages = []
        if req.shared_pages:
            if self._prefix_cache is not None:
                self._free_pages.extend(
                    self._prefix_cache.release(req.shared_pages))
                _metrics.gauge("serve.pages_shared").set(
                    self._prefix_cache.pages_shared())
            else:
                self._free_pages.extend(req.shared_pages)
            req.shared_pages = []

    def _map_prefix(self, req, total):
        """Match the prompt against the prefix cache and map the hit pages
        read-only into the slot's table row. Returns how many leading
        tokens are already cached. The match is capped at ``total - 1``
        so the last position is always prefilled (its logits give the
        first token); when the cap ends inside the last matched page,
        that page is copied to a private one first. A cache failure
        (the ``serve.prefix_cache`` fault point) degrades to a miss."""
        if self._prefix_cache is None or total <= 1:
            return 0
        cache = self._prefix_cache
        try:
            fault_point("serve.prefix_cache")
            shared, matched = cache.match(req.prompt, cap=total - 1)
        except Exception:
            shared, matched = [], 0
            cache.misses += req.prompt.size // self.cfg.page_size
        full = req.prompt.size // self.cfg.page_size
        _metrics.counter("serve.prefix_hits").inc(len(shared))
        _metrics.counter("serve.prefix_misses").inc(full - len(shared))
        if not shared:
            return 0
        cache.acquire(shared)
        req.shared_pages = list(shared)
        for idx, page in enumerate(shared):
            self._page_table[req.slot, idx] = page
        if matched % self.cfg.page_size and not self._cow_last_shared(req):
            # no page for the private copy: shrink the match to the page
            # boundary and let the tail prefill normally
            drop = req.shared_pages.pop()
            self._free_pages.extend(cache.release([drop]))
            matched -= matched % self.cfg.page_size
        _metrics.gauge("serve.pages_shared").set(cache.pages_shared())
        return matched

    def _cow_last_shared(self, req):
        """Copy-on-write: duplicate the request's last shared page into a
        fresh private page in every layer's pool (the draft's too: its
        pools are indexed by the same page ids) and remap the table row.
        False when no page is allocatable."""
        dst = self._alloc_page()
        if dst is None:
            return False
        src = req.shared_pages.pop()     # held: its refcount protects it
        src_t = torch.tensor([src], dtype=torch.int64, device=self._device)
        dst_t = torch.tensor([dst], dtype=torch.int64, device=self._device)
        for pool in self._caches + (self._draft_caches or []):
            copy_pages(pool, src_t, dst_t)
        self._free_pages.extend(self._prefix_cache.release([src]))
        req.pages.append(dst)
        self._page_table[req.slot, len(req.shared_pages)] = dst
        self.cow_copies += 1
        _metrics.counter("serve.cow_copies").inc()
        return True

    def _publish_prefix(self, req):
        """Register a just-prefilled prompt's full pages in the cache.
        Newly registered pages move from the request's private list to
        its shared list and keep their table positions."""
        if self._prefix_cache is None:
            return
        row = self._page_table[req.slot]
        full = req.prompt.size // self.cfg.page_size
        for page in self._prefix_cache.insert(req.prompt, row[:full]):
            req.pages.remove(page)
            req.shared_pages.append(page)
        _metrics.gauge("serve.pages_shared").set(
            self._prefix_cache.pages_shared())

    # --- per-request sampling ---

    def _resolve_sampling(self, req, temperature, top_k, top_p, seed):
        """Explicit knobs win, else the config's; a missing seed derives
        from the engine seed and the request id."""
        cfg = self.cfg
        req.temperature = (cfg.temperature if temperature is None
                           else float(temperature))
        req.top_k = cfg.top_k if top_k is None else int(top_k)
        req.top_p = cfg.top_p if top_p is None else float(top_p)
        req.seed = ((cfg.seed * 1_000_003 + req.id) & 0xFFFFFFFF
                    if seed is None else int(seed) & 0xFFFFFFFF)

    def _sampling_rows(self, req):
        """One request's ``[1]``-shaped knobs; the count is the tokens
        generated so far, so a replayed request redraws identically."""
        return (np.asarray([req.temperature], np.float32),
                np.asarray([req.top_k], np.int64),
                np.asarray([req.top_p], np.float32),
                np.asarray([req.seed], np.int64),
                np.asarray([len(req.tokens)], np.int64))

    # --- scheduling ---

    def _admission_key(self, req):
        """Highest priority, then earliest deadline (None last), then
        FIFO."""
        dl = req.deadline_t if req.deadline_t is not None else float("inf")
        return (-req.priority, dl, req.id)

    def _victim_key(self, req):
        """The inverse of admission: lowest priority, then latest deadline
        (None latest), then youngest."""
        dl = req.deadline_t if req.deadline_t is not None else float("inf")
        return (req.priority, -dl, -req.id)

    def _admit(self, finished):
        cfg = self.cfg
        while self._queue and self._free_slots:
            req = min(self._queue, key=self._admission_key)
            total = req.prompt.size + len(req.tokens)  # recovery replays
            first = min(cfg.prefill_len, total)
            if -(-first // cfg.page_size) > self._pages_available():
                _metrics.counter("serve.page_stalls").inc(where="admit")
                break                      # head of line waits for pages
            self._queue.remove(req)
            if not self._prefill_request(req, total, finished):
                break          # mid-admission page stall or a recovery
        _metrics.gauge("serve.queue_depth").set(len(self._queue))

    def _prefill_request(self, req, total, finished):
        """Admit one request: take a slot, map the cached leading pages of
        its prompt, then for each ``prefill_len`` chunk of the replay
        sequence (prompt + tokens kept by a recovery) that the match does
        not cover, grow the page table and run one prefill call; the
        last chunk's token is the next generated one. The prompt's full
        pages are then published to the cache. Returns False when
        admission must back off (pages ran out between chunks, or a
        failed chunk was recovered)."""
        cfg = self.cfg
        ps = cfg.page_size
        slot = self._free_slots.pop()
        req.slot = slot
        self._trace_event(req, "resumed" if (req.preemptions
                                             or req.recoveries)
                          else "admitted")
        self._page_table[slot] = 0
        req.pages = []
        req.shared_pages = []
        matched = self._map_prefix(req, total)
        tok = None
        skipped = 0
        for start in range(0, total, cfg.prefill_len):
            clen = min(cfg.prefill_len, total - start)
            if start + clen <= matched:
                skipped += clen   # fully cache-covered: no prefill call
                continue
            need = -(-(start + clen) // ps)
            while len(req.shared_pages) + len(req.pages) < need:
                page = self._alloc_page()
                if page is None:
                    # pool drained between chunks: undo and wait
                    _metrics.counter("serve.page_stalls").inc(where="admit")
                    self._abort_admission(req)
                    return False
                self._page_table[
                    slot, len(req.shared_pages) + len(req.pages)] = page
                req.pages.append(page)
            try:
                fault_point("serve.prefill")
                tok = self._prefill_chunk(req, start, clen, matched)
            except Exception as e:
                self._recover("serve.prefill", e, pending=req)
                return False
        self.prefill_tokens_skipped += skipped
        self._publish_prefix(req)
        self._lengths[slot] = total
        self._trace_event(req, "prefill_done")
        t = self._trace_event(req, "first_token")
        if req.first_token_t is None:     # a replay keeps the first
            req.first_token_t = t
            _metrics.histogram("serve.ttft_s").observe(t - req.submit_t)
        req.tokens.append(tok)
        req.status = "running"
        self._running[slot] = req
        self._temps[slot] = req.temperature
        self._top_ks[slot] = req.top_k
        self._top_ps[slot] = req.top_p
        self._seeds[slot] = req.seed
        self._gen_counts[slot] = len(req.tokens)
        self._last_tokens[slot] = tok
        self._active[slot] = True
        _metrics.counter("serve.tokens").inc()
        reason = self._done_reason(req, tok)
        if reason:
            self._release(req, finished, reason)
        return True

    def _abort_admission(self, req):
        """Undo a half-done admission: free the slot and pages (shared
        ones back to the cache) and requeue at the front."""
        self._free_slot_state(req)
        req.slot = None
        req.status = "queued"
        self._queue.appendleft(req)

    def _grow_pages(self):
        """Give each running slot the page its next token write needs
        where its length reached a page boundary; a slot that cannot get
        one stalls (is inactive) this round. Returns the stalled slots;
        safe to re-run after a preemption freed pages."""
        stalled = []
        ps = self.cfg.page_size
        for slot, req in self._running.items():
            self._active[slot] = True
            ln = int(self._lengths[slot])
            owned = len(req.shared_pages) + len(req.pages)
            if ln % ps or ln // ps < owned:
                continue                   # room in the current page
            page = self._alloc_page()
            if page is not None:
                req.pages.append(page)
                self._page_table[slot, ln // ps] = page
            else:
                _metrics.counter("serve.page_stalls").inc(where="decode")
                self._active[slot] = False
                stalled.append(slot)
        return stalled

    def _free_slot_state(self, req):
        """Return a request's slot and pages and zero the slot's rows.
        Leaves ``req.slot`` set; requeue paths clear it themselves."""
        slot = req.slot
        self._return_pages(req)
        self._page_table[slot] = 0
        self._lengths[slot] = 0
        self._active[slot] = False
        self._last_tokens[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 0.0
        self._seeds[slot] = 0
        self._gen_counts[slot] = 0
        self._running.pop(slot, None)
        self._free_slots.append(slot)

    def _preempt(self, req):
        """Recompute preemption: drop the request's pages and tokens and
        requeue it at the front; it re-prefills its prompt and
        regenerates (greedy exactly; sampled from the same stream)."""
        self._trace_event(req, "preempted", tokens_dropped=len(req.tokens))
        self._free_slot_state(req)
        req.slot = None
        req.tokens = []
        req.status = "queued"
        req.preemptions += 1
        self.preemptions += 1
        self._queue.appendleft(req)
        _metrics.counter("serve.preemptions").inc()

    def _recover(self, where, exc, pending=None):
        """Crash-isolated recovery from a failed decode step (or
        speculative round) or prefill chunk: the pools, the draft's too,
        may hold partial writes, so they are rebuilt (every reference to
        the old ones dropped first, so the card never holds two sets),
        the scheduler arrays zeroed, the prefix
        cache cleared, and every in-flight request requeued in id order
        to replay its prompt + generated tokens. The kernels stay on:
        nothing here switches to a plain version. After
        ``cfg.step_retries`` consecutive failures every request fails
        and ``exc`` is re-raised with its traceback; otherwise the
        traceback is dropped before the new pools are allocated, since
        the frames of the failed call may hold the old pools' tensors."""
        cfg = self.cfg
        self.recoveries += 1
        _metrics.counter("serve.recoveries").inc(where=where)
        victims = sorted(self._running.values(), key=lambda r: r.id)
        if pending is not None:
            victims.append(pending)
        if self._run_log is not None:
            self._run_log.write({
                "phase": "serve", "recovery": where,
                "step": self._step_no, "in_flight": len(victims),
                "error": f"{type(exc).__name__}: {exc}"[:200]})
        for pool in self._caches + (self._draft_caches or []):
            pool.clear()           # drop the old tensors before the new
        self._caches = []
        if self._spec_on:
            self._draft_caches = []
        self._page_table[:] = 0
        self._lengths[:] = 0
        self._active[:] = False
        self._last_tokens[:] = 0
        self._temps[:] = 0.0
        self._top_ks[:] = 0
        self._top_ps[:] = 0.0
        self._seeds[:] = 0
        self._gen_counts[:] = 0
        self._free_slots = list(range(cfg.num_slots))
        self._free_pages = collections.deque(range(cfg.num_pages))
        if self._prefix_cache is not None:
            self._prefix_cache.clear()     # its ids point at zeroed pages
            _metrics.gauge("serve.pages_shared").set(0)
        self._running = {}
        for req in reversed(victims):      # appendleft keeps id order
            req.slot = None
            req.pages = []
            req.shared_pages = []
            req.status = "queued"
            req.recoveries += 1
            if req.tokens or req.device_prompt is None:
                # the staged chunks hold the prompt only: restage the
                # replay sequence (prompt + generated tokens)
                req.device_prompt = self._stage_chunks(req.output)
            self._trace_event(req, "requeued", cause=where,
                              tokens_kept=len(req.tokens))
            self._queue.appendleft(req)
        _metrics.gauge("serve.active_slots").set(0)
        _metrics.gauge("serve.queue_depth").set(len(self._queue))
        try:
            self._retry_budget.failure(exc)   # backoff sleep, or raise
        except Exception:
            self._fail_all()
            raise
        while exc is not None:                # the chained ones too
            exc.__traceback__ = None
            exc = exc.__cause__ or exc.__context__
        self._build_pools()

    def _build_pools(self):
        """New target pools, and draft pools when speculation is on."""
        self._caches = self._new_caches()
        if self._spec_on:
            self._draft_caches = self._new_caches(self._draft_model)

    def _fail_all(self):
        """Recovery budget spent: retire every queued and running request
        as ``failed`` before the engine re-raises."""
        doomed = list(self._queue) + list(self._running.values())
        self._queue.clear()
        for req in doomed:
            if req.slot is not None:
                self._free_slot_state(req)
            self._retire_terminal(req, "failed", "engine_error")
        _metrics.gauge("serve.queue_depth").set(0)
        _metrics.gauge("serve.active_slots").set(0)

    # --- terminal statuses ---

    def _retire_terminal(self, req, status, why, finished=None,
                         account=True):
        """Retire a request on a path other than completion (rejected |
        shed | cancelled | failed). ``account`` counts it as a retirement
        that missed its SLO (the engine failed the client); cancel passes
        False."""
        req.status = status
        req.retire_reason = why
        req.done_t = self._clock()
        req.device_prompt = None
        if account:
            req.slo_ok = False
            self._retired += 1
            _metrics.gauge("serve.goodput").set(self.goodput())
        self._trace_event(req, "retired", reason=status, why=why,
                          tokens=len(req.tokens), slo_ok=bool(req.slo_ok),
                          preemptions=req.preemptions)
        _metrics.counter("serve.requests").inc(status=status)
        if finished is not None:
            finished.append(req)

    def _reject(self, req, why):
        """Terminal ``rejected`` at submit time; never started, so worth
        resubmitting."""
        req.retriable = True
        self._retire_terminal(req, "rejected", why)

    def _shed_expired(self, finished):
        """Shed every queued request whose deadline has passed."""
        if not self._queue:
            return
        now = self._clock()
        for req in [r for r in self._queue
                    if r.deadline_t is not None and now > r.deadline_t]:
            self._queue.remove(req)
            _metrics.counter("serve.shed").inc(cause="deadline")
            self._retire_terminal(req, "shed", "deadline_expired", finished)

    def _done_reason(self, req, tok):
        """Retirement reason for the token just emitted, or None."""
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new:
            return "length"
        return None

    def _account_slo(self, req):
        """Classify one retirement against the configured SLOs (0 is
        unbounded) and refresh ``serve.goodput``."""
        cfg = self.cfg
        ok = True
        if req.first_token_t is not None:
            ttft = req.first_token_t - req.submit_t
            if cfg.slo_ttft_s and ttft > cfg.slo_ttft_s:
                _metrics.counter("serve.slo_violations").inc(kind="ttft")
                ok = False
            if cfg.slo_token_latency_s and len(req.tokens) > 1:
                per_tok = ((req.done_t - req.first_token_t)
                           / (len(req.tokens) - 1))
                if per_tok > cfg.slo_token_latency_s:
                    _metrics.counter("serve.slo_violations").inc(
                        kind="token_latency")
                    ok = False
        req.slo_ok = ok
        self._retired += 1
        self._retired_ok += int(ok)
        _metrics.gauge("serve.goodput").set(self.goodput())

    def _release(self, req, finished, reason="length"):
        self._free_slot_state(req)
        req.status = "done"
        req.retire_reason = reason
        req.done_t = self._clock()
        req.device_prompt = None
        self._account_slo(req)
        self._trace_event(req, "retired", reason=reason,
                          tokens=len(req.tokens), slo_ok=req.slo_ok,
                          preemptions=req.preemptions,
                          spec_tokens=req.spec_tokens)
        finished.append(req)
        _metrics.counter("serve.requests").inc(status="completed")
