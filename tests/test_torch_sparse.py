"""The port's sparse-row tables against the JAX reference, on the CPU:
``unique_ids`` and ``segment_rowsum``, ``SparseTable`` pushes under SGD,
Adagrad and Adam (duplicate ids, so padded slots, included),
``HostTable`` (its seeded table bit for bit, its host pushes, equal to
``SparseTable``, prefetch racing push), ``FeatureTable`` under LRU and
LFU over one id stream (residency, evictions, the arena and the stale-push
drop), ``ShardedHostTable`` and the table-state bridge.

The same inputs, made with numpy from a seed, go through both packages;
a ``SparseTable``'s state crosses with ``bridge.export_table_state``. No
Pallas kernel lies on this path. Tolerance: f32 1e-5 (sums in another
order); rows no update reached are held bitwise, and ``unique_ids`` and
the host tiers' seeded draws exactly.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def n(x):
    return x.detach().cpu().numpy()


def _opts(kind, lr):
    """The same optimizer on both sides: (JAX object, port factory)."""
    import paddle_tpu as pt
    from paddle_tpu_torch import optimizer as O
    cls = {"sgd": "SGD", "adagrad": "Adagrad", "adam": "Adam"}[kind]
    return (getattr(pt.optimizer, cls)(lr),
            lambda ps: getattr(O, cls)(ps, lr))


# ------------------------------------------------------------- unique_ids

@pytest.mark.parametrize("ids,k", [
    ([[5, 3, 5], [3, 3, 9]], None),        # k = size > distinct: padding
    ([[7, 1, 4, 9]], None),                # all distinct: k = n
    ([4, 2, 2, 8, 4], 3),                  # k = n < size
    ([9, 9, 2], 7),                        # k > size
    ([6, 6, 6, 6], None),                  # one id
])
def test_unique_ids_equal_the_references_exactly(ids, k):
    from paddle_tpu.parallel.sparse import unique_ids as junique
    from paddle_tpu_torch.parallel import unique_ids
    a = np.asarray(ids, np.int32)
    ju, ji, jv = junique(jnp.asarray(a), k)
    tu, ti, tv = unique_ids(torch.from_numpy(a), k)
    np.testing.assert_array_equal(n(tu), np.asarray(ju))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    assert tu.dtype == torch.int32 and tuple(ti.shape) == a.shape
    # the padding is the first id, not the smallest
    assert (n(tu)[~n(tv)] == a.reshape(-1)[0]).all()


def test_unique_ids_refuses_a_k_below_the_distinct_count():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.parallel import unique_ids
    with pytest.raises(EnforceError, match="do not fit"):
        unique_ids(torch.tensor([1, 2, 3]), 2)


def test_segment_rowsum_equals_the_references():
    from paddle_tpu.parallel.sparse import segment_rowsum as jseg
    from paddle_tpu.parallel.sparse import unique_ids as junique
    from paddle_tpu_torch.parallel import segment_rowsum, unique_ids
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 6, (4, 5)).astype(np.int32)
    cot = rs.randn(4, 5, 3).astype(np.float32)
    ju, ji, _ = junique(jnp.asarray(ids))
    tu, ti, _ = unique_ids(torch.from_numpy(ids))
    want = jseg(jnp.asarray(cot), ji, ju.shape[0])
    got = segment_rowsum(torch.from_numpy(cot), ti, tu.shape[0])
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


# ------------------------------------------------------------ SparseTable

def _cot(emb, xp):
    w = xp.arange(emb.size if xp is jnp else emb.numel(),
                  dtype=emb.dtype).reshape(emb.shape) / 7.0
    return (xp.sin(emb) * w).sum()


def _sparse_pair(kind, lr, V=32, D=8, seed=0):
    from paddle_tpu.parallel.sparse import SparseTable as JTable
    from paddle_tpu_torch.bridge import export_table_state
    from paddle_tpu_torch.parallel import SparseTable
    jopt, topt = _opts(kind, lr)
    tt = SparseTable(V, D, topt)
    st = tt.init(seed=seed, device="cpu")
    jt = JTable(V, D, jopt)
    jst = jax.tree_util.tree_map(jnp.asarray, export_table_state(st))
    return tt, st, jt, jst


def _torch_step(tbl, st, ids):
    rows, ctx = tbl.pull(st, torch.from_numpy(ids))
    rows.requires_grad_(True)
    _cot(tbl.embed(rows, ctx), torch).backward()
    tbl.push(st, rows.grad, ctx)


def _jax_step(tbl, st, ids):
    rows, ctx = tbl.pull(st, jnp.asarray(ids))
    g = jax.grad(lambda r: _cot(tbl.embed(r, ctx), jnp))(rows)
    return tbl.push(st, g, ctx)


@pytest.mark.parametrize("kind,lr", [("sgd", 0.1), ("adagrad", 0.1),
                                     ("adam", 0.05)])
@pytest.mark.parametrize("dup", [False, True])
def test_sparse_table_push_equals_the_references(kind, lr, dup):
    """Three pull/push cycles: touched rows and slots within 1e-5,
    untouched ones bitwise, the step counted."""
    tt, st, jt, jst = _sparse_pair(kind, lr)
    t0 = {"table": st["table"].clone(),
          **{k: v.clone() for k, v in st["slots"].items()}}
    batches = ([[1, 7, 7, 30], [2, 7, 1, 1]] if dup else [[1, 7, 9, 30],
                                                          [2, 11, 3, 5]])
    ids = np.asarray(batches, np.int32)
    for i in range(3):
        b = ids[:, i % 2:]
        _torch_step(tt, st, b)
        jst = _jax_step(jt, jst, b)
    assert int(st["step"]) == int(jst["step"]) == 3
    touched = np.zeros(32, bool)
    touched[np.unique(ids)] = True
    np.testing.assert_allclose(n(st["table"]), np.asarray(jst["table"]),
                               **TOL)
    for name, s in st["slots"].items():
        np.testing.assert_allclose(n(s), np.asarray(jst["slots"][name]),
                                   **TOL)
        np.testing.assert_array_equal(n(s)[~touched],
                                      n(t0[name])[~touched])
    np.testing.assert_array_equal(n(st["table"])[~touched],
                                  n(t0["table"])[~touched])
    assert not np.allclose(n(st["table"])[touched],
                           n(t0["table"])[touched])


def test_padded_slots_never_overwrite_a_real_update_under_adam():
    """Under Adam a zero gradient still moves a row, so the padded slots
    (copies of the first id) carry a stale update; the push writes only
    the valid slots. A push that writes every slot (the planted fault)
    leaves the first id's row at the stale value, off the reference's."""
    from paddle_tpu_torch.parallel.sparse import _row_update
    tt, st, jt, jst = _sparse_pair("adam", 0.05)
    ids = np.asarray([[7, 7, 3], [3, 7, 3]], np.int32)   # k 6, n 2
    for _ in range(2):                    # moments nonzero before the push
        _torch_step(tt, st, ids)
        jst = _jax_step(jt, jst, ids)
    np.testing.assert_allclose(n(st["table"]), np.asarray(jst["table"]),
                               **TOL)
    # the planted fault: one more cycle writing all k slots
    rows, ctx = tt.pull(st, torch.from_numpy(ids))
    assert ctx["n"] == 2 and ctx["uniq"].numel() == 6
    rows.requires_grad_(True)
    _cot(tt.embed(rows, ctx), torch).backward()
    uniq = ctx["uniq"].long()
    new_rows, _ = _row_update(
        tt.opt, st["step"], st["table"][uniq],
        {k: v[uniq] for k, v in st["slots"].items()}, rows.grad)
    bad = st["table"].clone()
    for i in range(6):                    # in order: the last write wins
        bad[uniq[i]] = new_rows[i]
    jst = _jax_step(jt, jst, ids)
    _torch_step(tt, st, ids)
    np.testing.assert_allclose(n(st["table"]), np.asarray(jst["table"]),
                               **TOL)
    assert np.abs(n(bad[7]) - np.asarray(jst["table"][7])).max() > 1e-4


def test_table_state_bridge_round_trips():
    from paddle_tpu_torch.bridge import export_table_state, load_table_state
    tt, st, _, jst = _sparse_pair("adam", 0.05)
    _torch_step(tt, st, np.asarray([[1, 4, 4]], np.int32))
    back = load_table_state(tt, export_table_state(st), device="cpu")
    assert int(back["step"]) == 1 and back["step"].dtype == torch.int32
    for k in ("table",):
        assert torch.equal(back[k], st[k])
    for k, v in st["slots"].items():
        assert torch.equal(back["slots"][k], v)
    with pytest.raises(KeyError, match="slots"):
        load_table_state(tt, {"table": n(st["table"]), "step": 0,
                              "slots": {"moment": n(st["table"])}},
                         device="cpu")


# -------------------------------------------------------------- HostTable

@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
def test_host_table_init_and_pushes_equal_the_references(kind):
    """The seeded table bit for bit, then three host pushes of the same
    row gradients: table and slots within 1e-5, the untouched bitwise."""
    from paddle_tpu.parallel.sparse import HostTable as JHost
    from paddle_tpu_torch.parallel import HostTable
    jopt, topt = _opts(kind, 0.1)
    V, D = 50, 4
    th = HostTable(V, D, topt, seed=3)
    jh = JHost(V, D, jopt, seed=3)
    np.testing.assert_array_equal(th.table, jh.table)
    assert sorted(th.slots) == sorted(jh.slots)
    for k in th.slots:
        np.testing.assert_array_equal(th.slots[k], jh.slots[k])
    t0 = th.table.copy()
    rs = np.random.RandomState(1)
    touched = set()
    for _ in range(3):
        ids = rs.randint(0, V, (3, 4)).astype(np.int32)
        rows, uniq = th.pull(ids, device="cpu")
        jrows, juniq = jh.pull(ids)
        np.testing.assert_array_equal(n(rows), np.asarray(jrows))
        np.testing.assert_array_equal(uniq, juniq)
        g = rs.randn(len(uniq), D).astype(np.float32)
        th.push(uniq, torch.from_numpy(g))
        jh.push(juniq, jnp.asarray(g))
        touched.update(uniq.tolist())
    assert th.step == jh.step == 3
    np.testing.assert_allclose(th.table, jh.table, **TOL)
    for k in th.slots:
        np.testing.assert_allclose(th.slots[k], jh.slots[k], **TOL)
    rest = np.setdiff1d(np.arange(V), sorted(touched))
    np.testing.assert_array_equal(th.table[rest], t0[rest])
    assert th.nbytes() == jh.nbytes()


def test_host_table_matches_sparse_table():
    """The host tier applies the same math as the device tier (the
    reference's own test, on the port)."""
    from paddle_tpu_torch.parallel import HostTable, SparseTable
    from paddle_tpu_torch.optimizer import SGD
    V, D = 64, 4
    ids = np.asarray([[4, 9], [4, 60]], np.int32)
    dev = SparseTable(V, D, lambda ps: SGD(ps, 0.2))
    st = dev.init(seed=2, device="cpu")
    host = HostTable(V, D, lambda ps: SGD(ps, 0.2))
    host.table = n(st["table"]).copy()
    rows, ctx = dev.pull(st, torch.from_numpy(ids))
    rows.requires_grad_(True)
    (dev.embed(rows, ctx) ** 2).sum().backward()
    dev.push(st, rows.grad, ctx)
    hrows, uniq = host.pull(ids, device="cpu")
    hrows.requires_grad_(True)
    (host.embed_ids(hrows, uniq, ids) ** 2).sum().backward()
    host.push(uniq, hrows.grad)
    np.testing.assert_allclose(host.table, n(st["table"]), rtol=1e-6,
                               atol=1e-6)


def test_prefetch_racing_push_never_gives_torn_rows():
    """Pushes subtract 1 from every element of every row while prefetches
    gather all rows: each prefetched array must be one push's state,
    whole (every element the same integer)."""
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import HostTable
    V, D = 256, 512
    t = HostTable(V, D, lambda ps: SGD(ps, 1.0))
    t.table[:] = 0.0
    ids = np.arange(V)
    g = torch.ones((V, D))
    seen = []
    stop = threading.Event()

    def pusher():
        while not stop.is_set():
            t.push(ids, g)

    th = threading.Thread(target=pusher)
    th.start()
    try:
        for i in range(40):
            t.prefetch(ids, tag=i, device="cpu").join()
            rows, uniq = t.take_prefetched(i)
            seen.append(float(rows[0, 0]))
            assert torch.all(rows == rows[0, 0]), "torn prefetch"
            assert float(rows[0, 0]) == int(rows[0, 0])
    finally:
        stop.set()
        th.join()
    assert seen[-1] < 0


# ----------------------------------------------------------- FeatureTable

def _feature_stream(seed, steps=12, batch=6, space=40):
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        yield rs.randint(0, space, (batch,)).astype(np.int64) * 10 ** 9 + 7


@pytest.mark.parametrize("evict", ["lru", "lfu"])
def test_feature_table_equals_the_references(evict):
    """One id stream through both at capacity 16 (evictions happen):
    pulled rows, residency, evictions, the index, the arena and slots after
    Adagrad pushes, all equal within 1e-5 (the draws exactly)."""
    from paddle_tpu.parallel.sparse import FeatureTable as JFeat
    from paddle_tpu_torch.parallel import FeatureTable
    jopt, topt = _opts("adagrad", 0.1)
    tf = FeatureTable(4, 16, topt, evict=evict, seed=5)
    jf = JFeat(4, 16, jopt, evict=evict, seed=5)
    rs = np.random.RandomState(2)
    for ids in _feature_stream(0):
        rows, uniq, ctx = tf.pull(ids, device="cpu")
        jrows, juniq, jctx = jf.pull(ids)
        np.testing.assert_allclose(n(rows), np.asarray(jrows), **TOL)
        np.testing.assert_array_equal(ctx["slots"], jctx["slots"])
        g = rs.randn(len(uniq), 4).astype(np.float32)
        tf.push(ctx, torch.from_numpy(g))
        jf.push(jctx, jnp.asarray(g))
    assert tf.evictions == jf.evictions > 0
    assert tf.resident == jf.resident == 16
    assert tf._index == jf._index
    assert tf.step == jf.step
    np.testing.assert_allclose(tf.arena, jf.arena, **TOL)
    np.testing.assert_allclose(tf.slots["moment"], jf.slots["moment"],
                               **TOL)


def test_feature_table_stale_push_dropped_as_the_reference_drops_it():
    from paddle_tpu.parallel.sparse import FeatureTable as JFeat
    from paddle_tpu_torch.parallel import FeatureTable
    out = []
    for tbl, dev in ((FeatureTable(2, 1, evict="lru", seed=4), "cpu"),
                     (JFeat(2, 1, evict="lru", seed=4), None)):
        pull = (lambda ids, t=tbl: t.pull(ids, device="cpu")) if dev \
            else tbl.pull
        _, _, ctx_a = pull(np.array([111]))
        pull(np.array([222]))            # evicts 111, reuses its slot
        b_row = tbl.arena[tbl._index[222]].copy()
        tbl.push(ctx_a, np.full((1, 2), 99.0, np.float32))   # stale
        np.testing.assert_array_equal(tbl.arena[tbl._index[222]], b_row)
        _, _, ctx = pull(np.zeros((0,), np.int64))
        tbl.push(ctx, np.zeros((0, 2), np.float32))           # no-op
        out.append((b_row, tbl.step, tbl.evictions))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_sharded_host_table_equals_the_references():
    """Two shards over one sign stream: the summed pull buffers equal the
    JAX shards' (each row its owner's), pushes update the owners only."""
    from paddle_tpu.parallel.sparse import ShardedHostTable as JShard
    from paddle_tpu_torch.parallel import ShardedHostTable
    jopt0, topt0 = _opts("sgd", 0.5)
    jopt1, topt1 = _opts("sgd", 0.5)
    ts = [ShardedHostTable(4, 8, s, 2, optimizer=o, seed=9)
          for s, o in enumerate((topt0, topt1))]
    js = [JShard(4, 8, s, 2, optimizer=o, seed=9)
          for s, o in enumerate((jopt0, jopt1))]
    rs = np.random.RandomState(3)
    for ids in _feature_stream(1, steps=6, space=9):
        uniq = np.unique(ids)
        tp = [sh.pull_local(uniq, return_ctx=True, device="cpu")
              for sh in ts]
        jp = [sh.pull_local(uniq, return_ctx=True) for sh in js]
        rows = ShardedHostTable.sum_shards([b for b, _ in tp])
        jrows = JShard.sum_shards([b for b, _ in jp])
        np.testing.assert_allclose(n(rows), np.asarray(jrows), **TOL)
        for i, sign in enumerate(uniq):          # each row is its owner's
            owner = ts[int(sign) % 2].local
            np.testing.assert_array_equal(
                n(rows)[i], owner.arena[owner._index[int(sign)]])
        g = rs.randn(len(uniq), 4).astype(np.float32)
        for sh, (_, ctx) in zip(ts, tp):
            sh.push_local(torch.from_numpy(g), ctx)
        for sh, (_, ctx) in zip(js, jp):
            sh.push_local(jnp.asarray(g), ctx)
    for t, j in zip(ts, js):
        assert t.local._index == j.local._index
        np.testing.assert_allclose(t.local.arena, j.local.arena, **TOL)
        assert all(k % 2 == t.shard_id for k in t.local._index)
