"""Sparse-row training and beyond-HBM embedding tables (ref:
``paddle_tpu/parallel/sparse.py``), the SelectedRows / PSLib successor.

The cycle is the reference's: a step dedupes its ids into a static-size
buffer (:func:`unique_ids`), *pulls* those rows, computes the loss
through them (so autograd gives a ``[k, D]`` row gradient, never a dense
``[V, D]`` one) and *pushes* a row-wise optimizer update back.

* :class:`SparseTable` keeps table and slots in device memory.
* :class:`HostTable` keeps them in host RAM (numpy) by design: each step
  only the touched rows cross PCIe, as PSLib's pull and push do.
* :class:`FeatureTable` is the keyed host tier: int64 feature signs, a
  bounded arena and LRU/LFU eviction.
* :class:`ShardedHostTable` splits signs over shards by ``sign %
  num_shards``; here the shards live in one process and
  :meth:`ShardedHostTable.sum_shards` completes a pull.

A table's optimizer is one of the port's optimizers built by a factory
``optimizer(params)`` (``lambda ps: Adagrad(ps, 0.05)``; SGD(0.01) when
None) over a placeholder, since a ``torch.optim.Optimizer`` needs a
parameter. It never steps: the table lends itself its ``slots``, its
schedule ``lr(step)``, ``_begin(step)`` and the row update
``_update_leaf`` (no clip, no regularizer, as in the reference), and
keeps its own step count.
"""

import threading

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce


def unique_ids(ids, k=None):
    """Static-size unique: ``(uniq [k], inv (ids.shape), valid [k])`` as
    ``jnp.unique(flat, size=k, fill_value=flat[0], return_inverse=True)``
    gives them: the sorted distinct ids, padded with the **first** id of
    ``ids`` (a real id, so gathers stay in bounds); ``inv`` maps every
    position to its slot; ``valid`` masks the padding. ``k`` defaults to
    ``ids.numel()``. ``uniq`` keeps the ids' dtype and ``inv`` is int64.

    On the card ``torch.unique`` reads its output size on the host. A
    ``k`` below the number of distinct ids raises (the reference drops
    the rows past ``k``)."""
    return _unique(ids, k)[:3]


def _unique(ids, k):
    """:func:`unique_ids` and the number of valid slots, a host int."""
    flat = ids.reshape(-1)
    k = flat.numel() if k is None else int(k)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    n = uniq.numel()
    enforce(n <= k, f"unique_ids: {n} distinct ids do not fit in k={k}")
    if n < k:
        uniq = torch.cat([uniq, flat[:1].expand(k - n)])
    valid = torch.arange(k, device=flat.device) < n
    return uniq, inv.reshape(ids.shape), valid, n


def segment_rowsum(row_cotangents, inv, k):
    """Sum duplicate-id cotangents into unique rows (``[*, D] -> [k, D]``),
    the SelectedRows merge (ref: ``sparse.py:55``)."""
    flat = row_cotangents.reshape(-1, row_cotangents.shape[-1])
    out = torch.zeros((k, flat.shape[-1]), dtype=flat.dtype,
                      device=flat.device)
    return out.index_add_(0, inv.reshape(-1).long(), flat)


def _row_optimizer(factory, dim, dtype):
    """The table's optimizer, built by ``factory`` over an empty ``[0,
    dim]`` placeholder (SGD(0.01) when ``factory`` is None)."""
    if factory is None:
        from paddle_tpu_torch.optimizer.optimizers import SGD

        def factory(params):
            return SGD(params, 0.01)
    return factory([torch.zeros((0, dim), dtype=dtype)])


def _row_update(opt, step, rows, slots, grad):
    """One optimizer update of gathered rows: ``(new rows, new slots)``.
    ``step`` is a 0-d int32 tensor on the rows' device."""
    lr = opt.lr(step)
    opt._begin(step)
    return opt._update_leaf(grad, rows, slots, lr, step)


def _probe_slots(opt, dim, dtype):
    """The optimizer's slot names and their initial values on one row
    (ref: ``sparse.py:64``), for the host tiers to broadcast."""
    probe = opt.slots(torch.zeros((1, dim)))
    names = sorted(probe)
    return names, {n: probe[n].numpy().astype(dtype)[0] for n in names}


def _host_row_update(opt, step, rows_np, slots_np, grad):
    """:func:`_row_update` on host arrays (ref: ``sparse.py:73``): the
    rows and slots as CPU tensors over the numpy arrays, at the table's
    host step; returns numpy arrays."""
    new_p, new_s = _row_update(
        opt, torch.tensor(step, dtype=torch.int32), torch.from_numpy(rows_np),
        {n: torch.from_numpy(v) for n, v in slots_np.items()},
        torch.from_numpy(_host(grad)))
    return new_p.numpy(), {n: v.numpy() for n, v in new_s.items()}


def _host(x):
    """A tensor (on any device) or array as a numpy array: the push's read
    of the row gradient back to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_device(host_rows, device):
    """Host rows on ``device``. To the card they go through pinned memory
    without blocking the host; torch's pinned allocator keeps the block
    until the copy has completed, even once the tensor here is freed."""
    t = torch.from_numpy(host_rows)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _embed_from_rows(rows, uniq, ids, dim):
    """Map pulled unique rows back to per-position embeddings (the host
    inverse map, ref: ``sparse.py:85``)."""
    ids = np.asarray(ids)
    inv = np.searchsorted(uniq, ids.reshape(-1))
    return rows[torch.from_numpy(inv).to(rows.device)].reshape(
        tuple(ids.shape) + (dim,))


class SparseTable:
    """Device-resident embedding table with sparse-row training (ref:
    ``sparse.py:92``). ``state = {"table": [V, D], "step": int32,
    "slots": {name: [V, ...]}}`` on the device; the cycle

        rows, ctx = tbl.pull(state, ids)      # [k, D] touched rows
        ... loss through tbl.embed(rows, ctx) # differentiable wrt rows
        tbl.push(state, rows.grad, ctx)       # row-wise update in place

    puts only ``[k, D]`` tensors in the autograd graph."""

    def __init__(self, vocab_size, dim, optimizer=None, init_scale=0.01,
                 dtype=torch.float32):
        self.vocab_size, self.dim = vocab_size, dim
        self.opt = _row_optimizer(optimizer, dim, dtype)
        self.init_scale = init_scale
        self.dtype = dtype

    def init(self, seed=0, device="cuda"):
        """``init_scale * N(0, 1)`` drawn on the CPU from ``seed``, then
        moved to ``device``, with the optimizer's slots and step 0."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        table = torch.randn((self.vocab_size, self.dim), generator=gen,
                            dtype=self.dtype).mul_(self.init_scale).to(dev)
        return {"table": table,
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": self.opt.slots(table)}

    def pull(self, state, ids, k=None):
        """Gather the step's unique rows: ``(rows [k, D], ctx)``; ``rows``
        is a leaf that the caller may mark ``requires_grad_()``."""
        uniq, inv, valid, n = _unique(ids, k)
        rows = state["table"].index_select(0, uniq.long())
        return rows, {"uniq": uniq, "inv": inv, "valid": valid, "n": n}

    @staticmethod
    def embed(rows, ctx):
        """Expand pulled unique rows to per-position embeddings."""
        inv = ctx["inv"]
        return rows.index_select(0, inv.reshape(-1)).reshape(
            tuple(inv.shape) + tuple(rows.shape[1:]))

    @torch.no_grad()
    def push(self, state, row_grad, ctx):
        """Apply the optimizer to the touched rows only (lazy-mode
        semantics) and count the step; updates ``state`` in place and
        returns it. The padded slots of ``uniq`` repeat a real id, so only
        the first ``n`` (the valid ones) are written: a stale duplicate
        never overwrites the real update (the reference's
        ``mode="drop"``)."""
        uniq = ctx["uniq"].long()
        n = ctx["n"]
        table, slots, step = state["table"], state["slots"], state["step"]
        p_rows = table.index_select(0, uniq)
        s_rows = {name: s.index_select(0, uniq) for name, s in slots.items()}
        new_rows, new_srows = _row_update(self.opt, step, p_rows, s_rows,
                                          row_grad)
        idx = uniq[:n]
        table.index_copy_(0, idx, new_rows[:n].to(table.dtype))
        for name, s in slots.items():
            s.index_copy_(0, idx, new_srows[name][:n].to(s.dtype))
        step += 1
        return state


class HostTable:
    """Beyond-HBM tier (ref: ``sparse.py:156``): table and slots in host
    RAM as numpy arrays, the rows of a step pulled to the device and their
    update pushed back, PSLib's pull and push. The initial table is the
    reference's bit for bit: ``init_scale * RandomState(seed)
    .standard_normal((V, D))`` cast to ``dtype``. The row update runs on
    the host, on CPU tensors over the arrays, at the table's host step."""

    def __init__(self, vocab_size, dim, optimizer=None, init_scale=0.01,
                 seed=0, dtype=np.float32):
        self.vocab_size, self.dim = vocab_size, dim
        self.opt = _row_optimizer(optimizer, dim, torch.float32)
        rng = np.random.RandomState(seed)
        self.table = (init_scale *
                      rng.standard_normal((vocab_size, dim))).astype(dtype)
        self._slot_names, slot_init = _probe_slots(self.opt, dim, dtype)
        self.slots = {n: np.broadcast_to(slot_init[n],
                                         (vocab_size, dim)).copy()
                      for n in self._slot_names}
        self.step = 0
        self._pool = {}
        # guards _pool and table/slots: prefetch gathers on a background
        # thread while push writes rows in place
        self._lock = threading.Lock()

    def pull(self, ids, device="cuda"):
        """Host gather of the unique rows of ``ids``: ``(rows on device,
        uniq)``, ``uniq`` the sorted distinct ids (numpy)."""
        dev = resolve_device(device)
        flat = np.unique(np.asarray(ids).reshape(-1))
        with self._lock:
            host_rows = self.table[flat]
        return _to_device(host_rows, dev), flat

    def prefetch(self, ids, tag="next", device="cuda"):
        """Start a pull on a thread; collect it with
        :meth:`take_prefetched`. The gather and :meth:`push`'s writes
        serialize on the table lock, so prefetched rows are never torn
        mixes of old and new values (they are the state before or after a
        concurrent push, the reference's async-SGD semantics)."""
        def work():
            out = self.pull(ids, device)
            with self._lock:
                self._pool[tag] = out
        t = threading.Thread(target=work, daemon=True)
        t.start()
        return t

    def take_prefetched(self, tag="next"):
        with self._lock:
            return self._pool.pop(tag)

    def embed_ids(self, rows, uniq, ids):
        """Map pulled rows back to per-position embeddings."""
        return _embed_from_rows(rows, uniq, ids, self.dim)

    def push(self, uniq, row_grad):
        """The row-wise optimizer update in host memory; ``row_grad`` (on
        any device) is read back to the host."""
        p = self.table[uniq]
        slo = {n: self.slots[n][uniq] for n in self._slot_names}
        new_p, new_s = _host_row_update(self.opt, self.step, p, slo,
                                        row_grad)
        with self._lock:
            self.table[uniq] = new_p.astype(self.table.dtype)
            for n in self._slot_names:
                self.slots[n][uniq] = new_s[n].astype(self.slots[n].dtype)
        self.step += 1

    def nbytes(self):
        return self.table.nbytes + sum(v.nbytes for v in self.slots.values())


class FeatureTable:
    """PSLib-style keyed host table (ref: ``sparse.py:229``): arbitrary
    int64 feature signs, a host arena ``[capacity, D]`` with an id -> slot
    map, rows created on first touch and the coldest evicted when the
    arena is full (``evict="lru"``: least recently touched; ``"lfu"``:
    least often). An evicted sign is drawn afresh on its next touch."""

    def __init__(self, dim, capacity, optimizer=None, init_scale=0.01,
                 evict="lru", seed=0, dtype=np.float32):
        enforce(evict in ("lru", "lfu"), f"evict={evict!r}")
        self.dim, self.capacity, self.evict = dim, int(capacity), evict
        self.opt = _row_optimizer(optimizer, dim, torch.float32)
        self.init_scale = init_scale
        self._rng = np.random.RandomState(seed)
        self.arena = np.zeros((self.capacity, dim), dtype)
        self._slot_names, self._slot_init = _probe_slots(self.opt, dim,
                                                         dtype)
        self.slots = {n: np.zeros((self.capacity, dim), dtype)
                      for n in self._slot_names}
        self._index = {}          # feature sign -> arena slot
        self._rindex = {}         # arena slot -> feature sign
        self._free = list(range(self.capacity - 1, -1, -1))
        self._clock = 0
        self._score = np.zeros((self.capacity,), np.int64)  # recency/freq
        self.step = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def _touch(self, slot):
        self._clock += 1
        if self.evict == "lru":
            self._score[slot] = self._clock
        else:
            self._score[slot] += 1

    def _alloc(self, sign):
        if self._free:
            slot = self._free.pop()
        else:
            slot = int(np.argmin(self._score))
            old = self._rindex.pop(slot)
            del self._index[old]
            self.evictions += 1
        self._index[sign] = slot
        self._rindex[slot] = sign
        self.arena[slot] = (self.init_scale *
                            self._rng.standard_normal(self.dim))
        for n in self._slot_names:
            self.slots[n][slot] = self._slot_init[n]
        self._score[slot] = 0 if self.evict == "lfu" else self._clock
        return slot

    def pull(self, ids, device="cuda"):
        """Unique host gather, creating rows on first touch: ``(rows
        [k, D] on device, uniq signs [k], ctx)``; pass ``ctx`` to
        :meth:`push`."""
        dev = resolve_device(device)
        uniq = np.unique(np.asarray(ids).reshape(-1))
        with self._lock:
            slot_arr = np.empty((len(uniq),), np.int64)
            for i, sign in enumerate(uniq):
                s = self._index.get(int(sign))
                if s is None:
                    s = self._alloc(int(sign))
                self._touch(s)
                slot_arr[i] = s
            rows = self.arena[slot_arr]
        return _to_device(rows, dev), uniq, {"signs": uniq,
                                             "slots": slot_arr}

    def embed_ids(self, rows, uniq, ids):
        return _embed_from_rows(rows, uniq, ids, self.dim)

    def push(self, ctx, row_grad):
        """The row-wise update into the arena. A row whose slot went to
        another sign between pull and push (evicted under a prefetch) is
        dropped, by sign identity: PSLib's stale-update rule."""
        slot_arr = np.asarray(ctx["slots"], np.int64)
        signs = np.asarray(ctx["signs"])
        if slot_arr.size == 0:
            return
        g = _host(row_grad)
        with self._lock:
            live = np.array([self._rindex.get(int(sl)) == int(sg)
                             for sl, sg in zip(slot_arr, signs)], bool)
            if not live.any():
                self.step += 1
                return
            sl = slot_arr[live]
            p = self.arena[sl]
            slo = {n: self.slots[n][sl] for n in self._slot_names}
            new_p, new_s = _host_row_update(self.opt, self.step, p, slo,
                                            g[live])
            self.arena[sl] = new_p.astype(self.arena.dtype)
            for n in self._slot_names:
                self.slots[n][sl] = new_s[n].astype(self.slots[n].dtype)
            self.step += 1

    @property
    def resident(self):
        return len(self._index)


class ShardedHostTable:
    """The PSLib shard layout (ref: ``sparse.py:337``): shard ``shard_id``
    of ``num_shards`` owns the signs with ``sign % num_shards ==
    shard_id`` in a :class:`FeatureTable` of its own. Each shard gathers
    the rows it owns into a zero-filled ``[k, D]`` buffer and the buffers
    are summed (:meth:`sum_shards`, in one process) to complete the pull;
    a push updates only the owned rows. The reference's exchange across
    processes (a psum over the mesh, or a host all-gather) is not
    ported."""

    def __init__(self, dim, capacity_per_shard, shard_id, num_shards,
                 optimizer=None, **kw):
        self.shard_id, self.num_shards = int(shard_id), int(num_shards)
        self.dim = dim
        self.local = FeatureTable(dim, capacity_per_shard,
                                  optimizer=optimizer, **kw)

    def owns(self, signs):
        return (np.asarray(signs) % self.num_shards) == self.shard_id

    def pull_local(self, uniq, return_ctx=False, device="cuda"):
        """The owned subset of ``uniq`` gathered into a zero-filled ``[k,
        D]`` buffer on ``device``; with ``return_ctx`` also the ctx that
        :meth:`push_local` takes."""
        dev = resolve_device(device)
        uniq = np.asarray(uniq).reshape(-1)
        mine = self.owns(uniq)
        buf = np.zeros((len(uniq), self.dim), self.local.arena.dtype)
        if mine.any():
            rows, _, lctx = self.local.pull(uniq[mine], device="cpu")
            buf[mine] = rows.numpy()
            ctx = {"local": lctx, "positions": np.where(mine)[0]}
        else:
            ctx = {"local": None, "positions": np.empty((0,), np.int64)}
        out = _to_device(buf, dev)
        return (out, ctx) if return_ctx else out

    @staticmethod
    def sum_shards(buffers):
        """The in-process sum of the shards' pull buffers."""
        out = buffers[0]
        for b in buffers[1:]:
            out = out + b
        return out

    def push_local(self, row_grad, ctx):
        """Apply the (replicated) row gradient to the owned rows; ``ctx``
        from ``pull_local(uniq, return_ctx=True)``."""
        if ctx["local"] is None:
            return
        self.local.push(ctx["local"], _host(row_grad)[ctx["positions"]])
