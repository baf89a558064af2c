"""Continuous-batching serving engine over the paged KV cache — the greedy
core of ``paddle_tpu/serving/engine.py``.

What is ported: fixed-slot decode steps over all slots, paged KV memory
(requests own pages, grow one page at a time as they decode, and free
them when they finish), prefill-on-admit, and chunked prefill (a prompt
longer than ``prefill_len`` is admitted as ``ceil(len / prefill_len)``
fixed-shape ``[1, prefill_len]`` calls). Sampling is the greedy branch of
the reference's ``_sample`` (argmax, first index on ties).

What is not, and raises or is refused up front: temperature sampling
(``NotImplementedError``), the prefix cache, speculation, preemption
(``ServeConfig.resolve`` requires enough pages for every slot at
``max_len``, so the pool never runs dry), recovery, deadlines and
priorities, the metrics plane.

The scheduler state (page table, lengths, active mask, pending tokens)
is host numpy, copied to the model's device for each call; the page
pools live on the device and are updated in place.
"""

import collections
import dataclasses
import itertools
import time
import typing

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce


@dataclasses.dataclass
class ServeConfig:
    num_slots: int = 4           # the reference's serve_slots default
    page_size: int = 16          # the reference's serve_page_size default
    max_len: int = 256           # per-request cap: prompt + generated
    prefill_len: int = 64        # padded admission prompt length (fixed)
    num_pages: int = None        # None -> num_slots * ceil(max_len/page)
    cache_dtype: typing.Any = torch.float32
    kv_dtype: typing.Any = None  # torch.int8: int8 pages, per-row scales
    eos_id: int = None           # default EOS (submit() can override)
    default_max_new: int = 32

    def resolve(self):
        pages_per_slot = -(-self.max_len // self.page_size)
        if self.num_pages is None:
            self.num_pages = self.num_slots * pages_per_slot
        enforce(self.prefill_len <= self.max_len,
                "prefill_len must not exceed max_len")
        enforce(self.num_pages >= self.num_slots * pages_per_slot,
                f"num_pages={self.num_pages} < num_slots * ceil(max_len / "
                f"page_size) = {self.num_slots * pages_per_slot}: the port "
                "has no preemption, so every slot must be able to reach "
                "max_len")
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
    status: str = "queued"        # queued -> running -> done
    slot: int = None
    pages: list = dataclasses.field(default_factory=list)
    submit_t: float = None
    first_token_t: float = None
    done_t: float = None
    retire_reason: str = None     # "eos" | "length"

    @property
    def output(self):
        """prompt + generated tokens (the generate()-shaped sequence)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])


class ServingEngine:
    """submit()/step()/drain() continuous batching for a
    :class:`~paddle_tpu_torch.models.gpt.GPTDecoder`, on the model's
    device."""

    def __init__(self, model, config=None, clock=time.perf_counter):
        self.cfg = (config or ServeConfig()).resolve()
        cfg = self.cfg
        self._model = model.eval()
        self._device = model.device
        self._clock = clock
        self._pages_per_slot = -(-cfg.max_len // cfg.page_size)
        self._caches = model.init_paged_caches(
            cfg.num_pages, cfg.page_size, dtype=cfg.cache_dtype,
            kv_dtype=cfg.kv_dtype)
        s = cfg.num_slots
        self._page_table = np.zeros((s, self._pages_per_slot), np.int32)
        self._lengths = np.zeros(s, np.int32)
        self._active = np.zeros(s, bool)
        self._last_tokens = np.zeros(s, np.int32)
        self._free_slots = list(range(s))
        self._free_pages = collections.deque(range(cfg.num_pages))
        self._queue = collections.deque()
        self._running = {}
        self.requests = {}
        self._ids = itertools.count()
        self.decode_steps = 0
        self.prefill_calls = 0

    def _dev(self, array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(self._device)

    # --- public API ---

    def submit(self, prompt, max_new=None, eos_id=None, temperature=None):
        """Queue a prompt (at most ``max_len`` tokens; longer than
        ``prefill_len`` is admitted chunk by chunk); returns the request
        id. Only greedy decoding is ported: ``temperature > 0`` raises."""
        cfg = self.cfg
        if temperature is not None and temperature > 0:
            raise NotImplementedError("sampled decoding (temperature > 0) "
                                      "is not ported; the engine is greedy")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = max_new if max_new is not None else cfg.default_max_new
        enforce(1 <= prompt.size <= cfg.max_len,
                f"prompt length {prompt.size} not in [1, {cfg.max_len}]")
        enforce(prompt.size + max_new <= cfg.max_len,
                f"prompt {prompt.size} + max_new {max_new} exceeds "
                f"max_len {cfg.max_len}")
        req = Request(id=next(self._ids), prompt=prompt, max_new=max_new,
                      eos_id=eos_id if eos_id is not None else cfg.eos_id)
        req.submit_t = self._clock()
        self.requests[req.id] = req
        self._queue.append(req)
        return req.id

    @torch.inference_mode()
    def step(self):
        """One scheduling round: admit queued prompts into free slots
        (prefill-on-admit), grow page tables where the next token opens a
        page, run one decode step over all slots, and retire requests
        that hit EOS or their token budget. Returns the requests finished
        this round."""
        finished = []
        self._admit(finished)
        self._grow_pages()
        if self._active.any():
            logits, self._caches = self._model.paged_decode_step(
                self._dev(self._last_tokens), self._caches,
                self._dev(self._page_table), self._dev(self._lengths),
                self._dev(self._active))
            # the one sync per round: the scheduler needs the tokens
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
            self.decode_steps += 1
            for slot, req in list(self._running.items()):
                if not self._active[slot]:
                    continue
                self._lengths[slot] += 1       # pending token now cached
                tok = int(toks[slot])
                req.tokens.append(tok)
                self._last_tokens[slot] = tok
                reason = self._done_reason(req, tok)
                if reason:
                    self._release(req, finished, reason)
        return finished

    def drain(self, max_steps=100000):
        """Run step() until every submitted request finishes; returns the
        finished requests in completion order."""
        out = []
        for _ in range(max_steps):
            if not (self._queue or self._running):
                break
            out.extend(self.step())
        else:
            raise RuntimeError(
                f"drain: {len(self._queue)} queued / {len(self._running)} "
                f"running requests left after {max_steps} steps")
        return out

    def kv_pool_bytes(self):
        return sum(t.numel() * t.element_size()
                   for pool in self._caches for t in pool.values())

    # --- scheduling ---

    def _admit(self, finished):
        while self._queue and self._free_slots:
            self._prefill_request(self._queue.popleft(), finished)

    def _prefill_request(self, req, finished):
        """Admit one request: take a slot, then for each ``prefill_len``
        chunk of the prompt grow the page table and run one prefill call;
        the last chunk's greedy token is the first generated token."""
        cfg = self.cfg
        slot = self._free_slots.pop()
        req.slot = slot
        self._page_table[slot] = 0
        req.pages = []
        total = req.prompt.size
        lp = cfg.prefill_len
        tok = None
        for start in range(0, total, lp):
            clen = min(lp, total - start)
            need = -(-(start + clen) // cfg.page_size)
            while len(req.pages) < need:
                page = self._free_pages.popleft()   # never empty: resolve()
                self._page_table[slot, len(req.pages)] = page
                req.pages.append(page)
            window = np.zeros((1, lp), np.int32)
            window[0, :clen] = req.prompt[start:start + clen]
            logits, self._caches = self._model.paged_prefill_chunk(
                self._dev(window), torch.tensor([start], dtype=torch.int32),
                torch.tensor([clen], dtype=torch.int32), self._caches,
                self._dev(self._page_table[slot][None, :]))
            self.prefill_calls += 1
            tok = int(torch.argmax(logits[0]))
        self._lengths[slot] = total
        req.first_token_t = self._clock()
        req.tokens.append(tok)
        req.status = "running"
        self._running[slot] = req
        self._last_tokens[slot] = tok
        self._active[slot] = True
        reason = self._done_reason(req, tok)
        if reason:
            self._release(req, finished, reason)

    def _grow_pages(self):
        """Give each running slot the page its next token write needs
        where its length crossed a page boundary."""
        ps = self.cfg.page_size
        for slot, req in self._running.items():
            ln = int(self._lengths[slot])
            if ln % ps or ln // ps < len(req.pages):
                continue                   # room in the current page
            page = self._free_pages.popleft()       # never empty: resolve()
            req.pages.append(page)
            self._page_table[slot, ln // ps] = page

    def _free_slot_state(self, req):
        slot = req.slot
        self._free_pages.extend(req.pages)
        req.pages = []
        self._page_table[slot] = 0
        self._lengths[slot] = 0
        self._active[slot] = False
        self._last_tokens[slot] = 0
        self._running.pop(slot, None)
        self._free_slots.append(slot)

    def _done_reason(self, req, tok):
        """Retirement reason for the token just emitted, or None."""
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new:
            return "length"
        return None

    def _release(self, req, finished, reason="length"):
        self._free_slot_state(req)
        req.status = "done"
        req.retire_reason = reason
        req.done_t = self._clock()
        finished.append(req)
