"""The port's CTR path against the JAX reference, on the CPU: the sigmoid
loss (and its gradient at exactly 0), the initializers and the embedding's
padding, DeepFM in both modes and Wide&Deep (logits, loss, every
gradient), three ``make_sparse_deepfm_train_step`` steps against the
jitted JAX step, the sparse step equal to the dense one under SGD, the
Trainer's Downpour cycle, ``Auc``/``ctr_metric_bundle`` and the metrics
beside them, the recommender and word2vec's N-gram LM, and the device
rule of every new entry point.

Weights are drawn by the port and bridged (``bridge.export_params``,
``export_table_state``); batches are made with numpy from a seed. No
Pallas kernel lies on this path. Tolerance: f32 1e-5 (sums in another
order), the host tiers' draws exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().cpu().numpy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close_tree(port_named, jax_tree, tol=TOL):
    flat = _flat(jax_tree)
    assert sorted(port_named) == sorted(flat)
    for name, v in port_named.items():
        np.testing.assert_allclose(n(v), flat[name], err_msg=name, **tol)


def _batch(cfg, b, seed):
    rs = np.random.RandomState(seed)
    dense = rs.rand(b, cfg.num_dense_fields).astype(np.float32)
    sparse = rs.randint(0, cfg.vocab_size,
                        (b, cfg.num_sparse_fields)).astype(np.int32)
    labels = rs.randint(0, 2, (b, 1)).astype(np.float32)
    return dense, sparse, labels


# ------------------------------------------------------------ the loss

@pytest.mark.parametrize("label", [1.0, 0.0])
def test_sigmoid_loss_gradient_at_zero_is_jaxs(label):
    """At x == 0 jax.grad gives -1.0 (label 1) and 0.0 (label 0): the
    max splits its gradient (0.5) and |x|'s is +1. torch.abs (gradient 0)
    and F.binary_cross_entropy_with_logits give -0.5 and 0.5: both are
    held off here as planted faults."""
    from paddle_tpu.ops.loss import sigmoid_cross_entropy_with_logits as jl
    from paddle_tpu_torch.ops.loss import sigmoid_cross_entropy_with_logits
    x = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    lab = np.full(4, label, np.float32)
    want = np.asarray(jax.grad(lambda v: jl(v, jnp.asarray(lab)).sum())(
        jnp.asarray(x)))
    assert want[0] == (-1.0 if label else 0.0)
    xt = t(x).requires_grad_(True)
    sigmoid_cross_entropy_with_logits(xt, t(lab)).sum().backward()
    np.testing.assert_allclose(n(xt.grad), want, rtol=1e-6, atol=0)

    def abs_version(v, y):
        return (torch.maximum(v, torch.zeros(())) - v * y
                + torch.log1p(torch.exp(-torch.abs(v))))
    for fault in (abs_version,
                  lambda v, y: torch.nn.functional
                  .binary_cross_entropy_with_logits(v, y, reduction="none")):
        xf = t(x).requires_grad_(True)
        fault(xf, t(lab)).sum().backward()
        assert abs(float(xf.grad[0]) - want[0]) == 0.5


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_loss_equals_the_references(normalize):
    from paddle_tpu.ops.loss import sigmoid_cross_entropy_with_logits as jl
    from paddle_tpu_torch.ops.loss import sigmoid_cross_entropy_with_logits
    rs = np.random.RandomState(0)
    x = (rs.randn(6, 3) * 4).astype(np.float32)
    x[0, 0] = 0.0
    lab = rs.randint(0, 2, (6, 3)).astype(np.float32)
    lab[1, 1] = lab[4, 2] = -100.0                     # ignored entries
    cot = rs.randn(6, 3).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jl(v, jnp.asarray(lab),
                                     normalize=normalize), jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = sigmoid_cross_entropy_with_logits(xt, t(lab), normalize=normalize)
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(n(xt.grad), np.asarray(vjp(
        jnp.asarray(cot))[0]), **TOL)
    assert float(got[1, 1]) == 0.0 and float(xt.grad[1, 1]) == 0.0


# ------------------------------------------------- initializers, embedding

def test_initializers_constant_zeros_normal():
    from paddle_tpu_torch import initializer as I
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(I.constant(2.5)((2, 3), gen), torch.full((2, 3), 2.5))
    assert torch.equal(I.zeros()((4,), gen), torch.zeros(4))
    w = I.normal(1.0, 0.01)((20000,), torch.Generator().manual_seed(1))
    assert abs(float(w.mean()) - 1.0) < 1e-3
    assert abs(float(w.std()) - 0.01) < 1e-3
    again = I.normal(1.0, 0.01)((20000,), torch.Generator().manual_seed(1))
    assert torch.equal(w, again)


def test_embedding_padding_idx_equals_the_references():
    from paddle_tpu.nn import Embedding as JEmb
    from paddle_tpu_torch.nn import Embedding
    emb = Embedding(10, 4, padding_idx=0, gen=torch.Generator().manual_seed(0))
    ids = np.array([[0, 3, 0], [9, 0, 3]], np.int32)
    cot = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    j = JEmb(10, 4, padding_idx=0)
    p = {"weight": n(emb.weight)}
    want, vjp = jax.vjp(lambda w: j.apply({"params": {"weight": w},
                                           "state": {}}, jnp.asarray(ids)),
                        jnp.asarray(p["weight"]))
    out = emb(t(ids))
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(n(out), np.asarray(want), **TOL)
    np.testing.assert_allclose(n(emb.weight.grad),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **TOL)
    assert float(emb.weight.grad[0].abs().sum()) == 0.0


# --------------------------------------------------------------- models

def _grads_of(model):
    return {k: p.grad for k, p in model.named_parameters()}


def test_deepfm_dense_mode_equals_the_references():
    from paddle_tpu.models.ctr import DeepFM as JDeepFM
    from paddle_tpu.models.ctr import ctr_loss as jloss
    from paddle_tpu_torch.bridge import export_params
    from paddle_tpu_torch.models.ctr import CTRConfig, DeepFM, ctr_loss
    cfg = CTRConfig.tiny()
    m = DeepFM(cfg, device="cpu", seed=3)
    # a nonzero first-order table, so its gradient path is exercised
    with torch.no_grad():
        m.fm_linear.weight.normal_(0, 0.1,
                                   generator=torch.Generator().manual_seed(9))
    params = export_params(m)
    dense, sparse, labels = _batch(cfg, 16, 1)
    j = JDeepFM(cfg)

    def jl(p):
        logits = j.apply({"params": p, "state": {}}, jnp.asarray(dense),
                         jnp.asarray(sparse))
        return jloss(logits, jnp.asarray(labels)), logits
    (jv, jlogits), jg = jax.value_and_grad(jl, has_aux=True)(params)
    logits = m(t(dense), t(sparse))
    loss = ctr_loss(logits, t(labels))
    loss.backward()
    np.testing.assert_allclose(n(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-6)
    _close_tree(_grads_of(m), jg)
    assert m.embed.weight.grad.shape == (cfg.total_vocab, cfg.embed_dim)


def test_deepfm_sparse_mode_equals_the_references():
    """forward_from_emb: logits and the gradients of the head, of emb and
    of the first-order weights."""
    from paddle_tpu.models.ctr import DeepFM as JDeepFM
    from paddle_tpu.models.ctr import ctr_loss as jloss
    from paddle_tpu_torch.bridge import export_params
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.ctr import CTRConfig, DeepFM, ctr_loss
    cfg = CTRConfig.tiny()
    m = DeepFM(cfg, sparse_tables=True, device="cpu", seed=4)
    assert "embed.weight" not in dict(m.named_parameters())
    rs = np.random.RandomState(2)
    dense, _, labels = _batch(cfg, 8, 2)
    emb = (rs.randn(8, cfg.num_sparse_fields, cfg.embed_dim) * 0.1
           ).astype(np.float32)
    first = (rs.randn(8, cfg.num_sparse_fields, 1) * 0.1).astype(np.float32)
    j = JDeepFM(cfg, sparse_tables=True)

    def jl(p, e, f):
        logits = j.apply({"params": p, "state": {}}, jnp.asarray(dense), e,
                         f, method="forward_from_emb")
        return jloss(logits, jnp.asarray(labels))
    jv, (gp, ge, gf) = jax.value_and_grad(jl, argnums=(0, 1, 2))(
        export_params(m), jnp.asarray(emb), jnp.asarray(first))
    et, ft = t(emb).requires_grad_(True), t(first).requires_grad_(True)
    loss = ctr_loss(m.forward_from_emb(t(dense), et, ft), t(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-6)
    _close_tree(_grads_of(m), gp)
    np.testing.assert_allclose(n(et.grad), np.asarray(ge), **TOL)
    np.testing.assert_allclose(n(ft.grad), np.asarray(gf), **TOL)
    with pytest.raises(EnforceError, match="forward_from_emb"):
        m(t(dense), t(np.zeros((8, 4), np.int32)))


def test_wide_and_deep_equals_the_references():
    from paddle_tpu.models.ctr import WideAndDeep as JWD
    from paddle_tpu.models.ctr import ctr_loss as jloss
    from paddle_tpu_torch.bridge import export_params
    from paddle_tpu_torch.models.ctr import CTRConfig, WideAndDeep, ctr_loss
    cfg = CTRConfig.tiny()
    m = WideAndDeep(cfg, device="cpu", seed=5)
    assert float(m.wide.weight.abs().sum()) == 0.0       # zeros, as JAX's
    with torch.no_grad():
        m.wide.weight.normal_(0, 0.1,
                              generator=torch.Generator().manual_seed(8))
    dense, sparse, labels = _batch(cfg, 12, 3)
    j = JWD(cfg)

    def jl(p):
        logits = j.apply({"params": p, "state": {}}, jnp.asarray(dense),
                         jnp.asarray(sparse))
        return jloss(logits, jnp.asarray(labels)), logits
    (jv, jlogits), jg = jax.value_and_grad(jl, has_aux=True)(
        export_params(m))
    logits = m(t(dense), t(sparse))
    loss = ctr_loss(logits, t(labels))
    loss.backward()
    np.testing.assert_allclose(n(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-6)
    _close_tree(_grads_of(m), jg)


def test_bench_ctr_config_has_the_references_parameter_count():
    from paddle_tpu_torch.models.ctr import CTRConfig, DeepFM
    cfg = CTRConfig(num_sparse_fields=26, num_dense_fields=13,
                    vocab_size=100_000, embed_dim=16, hidden=(400, 400, 400))
    m = DeepFM(cfg, sparse_tables=True, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == 493_215
    assert cfg.total_vocab == 2_600_000


# ------------------------------------------------------- the sparse step

def _sparse_setup(cfg, seed, head_opt, tbl_opt):
    """The port's DeepFM, optimizer and both tables, with the JAX side's
    bridged copies."""
    import paddle_tpu as pt
    from paddle_tpu.models.ctr import DeepFM as JDeepFM
    from paddle_tpu.parallel.sparse import SparseTable as JTable
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.bridge import export_params, export_table_state
    from paddle_tpu_torch.models.ctr import DeepFM
    from paddle_tpu_torch.parallel import SparseTable
    (hcls, hlr), (tcls, tlr) = head_opt, tbl_opt
    m = DeepFM(cfg, sparse_tables=True, device="cpu", seed=seed)
    opt = getattr(O, hcls)(m.parameters(), hlr)
    tbls = [SparseTable(cfg.total_vocab, d,
                        lambda ps: getattr(O, tcls)(ps, tlr))
            for d in (cfg.embed_dim, 1)]
    states = [tb.init(seed=seed + 1 + i, device="cpu")
              for i, tb in enumerate(tbls)]
    jside = dict(model=JDeepFM(cfg, sparse_tables=True),
                 opt=getattr(pt.optimizer, hcls)(hlr),
                 tbls=[JTable(cfg.total_vocab, d,
                              getattr(pt.optimizer, tcls)(tlr))
                       for d in (cfg.embed_dim, 1)],
                 # copies: a CPU tensor's .numpy() shares its memory,
                 # and the port's step writes the parameters in place
                 params=jax.tree_util.tree_map(
                     lambda a: jnp.asarray(np.array(a)), export_params(m)),
                 states=[jax.tree_util.tree_map(jnp.asarray,
                                                export_table_state(s))
                         for s in states])
    jside["opt_state"] = jside["opt"].init(jside["params"])
    return m, opt, tbls, states, jside


def test_sparse_deepfm_steps_equal_the_jitted_reference():
    """Three steps (Adam on the head, Adagrad on both tables) from bridged
    weights and table states, new batches each step with repeated ids:
    loss, head parameters, both tables and their moments."""
    from paddle_tpu.models.ctr import make_sparse_deepfm_train_step as jmake
    from paddle_tpu_torch.models.ctr import (CTRConfig,
                                             make_sparse_deepfm_train_step)
    cfg = CTRConfig.tiny()
    m, opt, tbls, states, js = _sparse_setup(cfg, 6, ("Adam", 1e-2),
                                             ("Adagrad", 0.05))
    step = make_sparse_deepfm_train_step(m, opt, *tbls, *states)
    jstep = jax.jit(jmake(js["model"], js["opt"], *js["tbls"]))
    p, o, (e, l_) = js["params"], js["opt_state"], js["states"]
    for i in range(3):
        dense, sparse, labels = _batch(cfg, 16, 10 + i)
        sparse[:, 0] = sparse[0, 0]                       # duplicates
        loss = step(t(dense), t(sparse), t(labels))
        jloss, p, o, e, l_ = jstep(p, o, e, l_, jnp.asarray(dense),
                                   jnp.asarray(sparse), jnp.asarray(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_tree(dict(m.named_parameters()), p)
    for st, jst in zip(states, (e, l_)):
        assert int(st["step"]) == int(jst["step"]) == 3
        np.testing.assert_allclose(n(st["table"]), np.asarray(jst["table"]),
                                   **TOL)
        np.testing.assert_allclose(n(st["slots"]["moment"]),
                                   np.asarray(jst["slots"]["moment"]), **TOL)


def test_sparse_step_equals_the_dense_step_under_sgd():
    """The reference's own test on the port: DeepFM's sparse step with
    its tables seeded from a dense DeepFM's embeddings equals the dense
    model's SGD step (loss, head, both tables)."""
    from paddle_tpu_torch.models.ctr import (CTRConfig, DeepFM, ctr_loss,
                                             make_sparse_deepfm_train_step)
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import SparseTable
    cfg = CTRConfig.tiny()
    dm = DeepFM(cfg, device="cpu", seed=3)
    with torch.no_grad():
        dm.fm_linear.weight.normal_(0, 0.1,
                                    generator=torch.Generator().manual_seed(2))
    sm = DeepFM(cfg, sparse_tables=True, device="cpu", seed=0)
    sm.load_state_dict({k: v for k, v in dm.state_dict().items()
                        if not k.startswith(("embed", "fm_linear"))})
    tbls = [SparseTable(cfg.total_vocab, d, lambda ps: SGD(ps, 0.1))
            for d in (cfg.embed_dim, 1)]
    states = [tb.init(seed=1, device="cpu") for tb in tbls]
    states[0]["table"].copy_(dm.embed.weight.detach())
    states[1]["table"].copy_(dm.fm_linear.weight.detach())
    dense, sparse, labels = _batch(cfg, 16, 1)
    dopt = SGD(dm.parameters(), 0.1)
    dloss = dopt.minimize(dm, lambda mm: ctr_loss(mm(t(dense), t(sparse)),
                                                  t(labels)))
    step = make_sparse_deepfm_train_step(sm, SGD(sm.parameters(), 0.1),
                                         *tbls, *states)
    sloss = step(t(dense), t(sparse), t(labels))
    np.testing.assert_allclose(float(sloss), float(dloss), rtol=1e-6)
    np.testing.assert_allclose(n(states[0]["table"]), n(dm.embed.weight),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(states[1]["table"]),
                               n(dm.fm_linear.weight), rtol=1e-5, atol=1e-6)
    dn = dict(dm.named_parameters())
    for k, v in sm.named_parameters():
        np.testing.assert_allclose(n(v), n(dn[k]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- Trainer

class _Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))


def _downpour(port):
    """The JAX test_trainer_sparse_downpour_cycle setup (one ingestion
    thread, so both sides take the batches in one order), with a scale
    ``w`` trained beside the table: (table, w, steps, initial table)."""
    rs = np.random.RandomState(0)
    V, D = 200, 4
    samples = [(rs.randint(0, V, (5,)).astype(np.int32),)
               for _ in range(24)]
    if port:
        from paddle_tpu_torch.data import InMemoryDataset
        from paddle_tpu_torch.optimizer import SGD
        from paddle_tpu_torch.parallel import HostTable
        from paddle_tpu_torch.static import Trainer, TrainerConfig
        table = HostTable(V, D, lambda ps: SGD(ps, 0.5), seed=3)
        t0 = table.table.copy()
        model = _Scale()

        def loss_fn(m, ids, rows, inv):
            return torch.mean(torch.square(m.w * rows[inv]))
        tr = Trainer(model, SGD(model.parameters(), 0.1), loss_fn,
                     TrainerConfig(num_ingest_threads=1),
                     sparse_tables=[(table, lambda b: b[0])], device="cpu")
        stats = tr.train(InMemoryDataset(samples), batch_size=8)
        return table, float(model.w), stats["steps"], t0, samples
    import paddle_tpu as pt
    from paddle_tpu.parallel import HostTable as JHost
    from paddle_tpu.static.trainer import Trainer as JTrainer
    from paddle_tpu.static.trainer import TrainerConfig as JConfig
    table = JHost(V, D, pt.optimizer.SGD(0.5), seed=3)
    t0 = table.table.copy()

    @jax.jit
    def step(st, ids, rows, inv):
        def loss_fn(w, r):
            return jnp.mean(jnp.square(w * jnp.take(r, inv, axis=0)))
        loss, (gw, gr) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            st["w"], rows)
        return loss, {"w": st["w"] - 0.1 * gw}, gr
    tr = JTrainer(step, JConfig(num_ingest_threads=1),
                  sparse_tables=[(table, lambda batch: batch[0])])
    st, stats = tr.train({"w": jnp.ones(())}, pt.data.InMemoryDataset(
        samples), batch_size=8)
    return table, float(st["w"]), stats["steps"], t0, samples


def test_trainer_downpour_cycle_equals_the_references():
    table, w, steps, t0, samples = _downpour(port=True)
    jtable, jw, jsteps, jt0, _ = _downpour(port=False)
    np.testing.assert_array_equal(t0, jt0)          # same seed, same table
    assert steps == jsteps == 3 and table.step == jtable.step == 3
    np.testing.assert_allclose(table.table, jtable.table, **TOL)
    np.testing.assert_allclose(w, jw, rtol=1e-5)
    touched = np.unique(np.concatenate([s[0] for s in samples]))
    rest = np.setdiff1d(np.arange(200), touched)
    np.testing.assert_array_equal(table.table[rest], t0[rest])
    assert not np.allclose(table.table[touched], t0[touched])


def test_trainer_guardian_with_sparse_tables_raises():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.data import InMemoryDataset
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import HostTable
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    model = _Scale()
    tr = Trainer(model, SGD(model.parameters(), 0.1),
                 lambda m, ids, rows, inv: rows.sum() * m.w,
                 TrainerConfig(guardian=True),
                 sparse_tables=[(HostTable(10, 2), lambda b: b[0])],
                 device="cpu")
    with pytest.raises(EnforceError, match="sparse_tables"):
        tr.train(InMemoryDataset([(np.array([1, 2], np.int32),)]))


def test_trainer_trains_deepfm_through_host_tables():
    """DeepFM through two HostTables and the Trainer over synthetic_ctr
    (the chip's ctr_host phase at the tiny config): finite losses, touched
    rows moved, the rest bit-identical, the loss down over 30 passes."""
    from paddle_tpu_torch.data import InMemoryDataset, synthetic_ctr
    from paddle_tpu_torch.models.ctr import CTRConfig, DeepFM, ctr_loss
    from paddle_tpu_torch.optimizer import Adagrad, Adam
    from paddle_tpu_torch.parallel import HostTable
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    cfg = CTRConfig.tiny()
    F, K = cfg.num_sparse_fields, cfg.embed_dim
    offsets = np.arange(F) * cfg.vocab_size
    model = DeepFM(cfg, sparse_tables=True, device="cpu", seed=0)
    tbls = [HostTable(cfg.total_vocab, d, lambda ps: Adagrad(ps, 0.05),
                      seed=1 + i) for i, d in enumerate((K, 1))]
    t0 = [tb.table.copy() for tb in tbls]

    def loss_fn(m, dense, sparse, labels, erows, einv, lrows, linv):
        b = dense.shape[0]
        return ctr_loss(m.forward_from_emb(
            dense, erows[einv].reshape(b, F, K),
            lrows[linv].reshape(b, F, 1)), labels)
    samples = list(synthetic_ctr(64, F, cfg.num_dense_fields,
                                 cfg.vocab_size, seed=0))
    tr = Trainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                 TrainerConfig(num_ingest_threads=1, log_every=1),
                 sparse_tables=[(tb, lambda b: b[1] + offsets)
                                for tb in tbls], device="cpu")
    for _ in range(30):
        tr.train(InMemoryDataset(samples), batch_size=16)
    losses = [v for _, v in tr.history]
    assert len(losses) == 120 and np.all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    touched = np.unique(np.stack([s[1] for s in samples]) + offsets)
    rest = np.setdiff1d(np.arange(cfg.total_vocab), touched)
    for tb, init in zip(tbls, t0):
        np.testing.assert_array_equal(tb.table[rest], init[rest])
        assert (tb.table[touched] != init[touched]).any(axis=1).all()
        assert (tb.slots["moment"][touched] > 0).any(axis=1).all()


# ------------------------------------------------------------- metrics

def test_auc_and_binary_metrics_equal_the_references():
    from paddle_tpu import metrics as J
    from paddle_tpu_torch import metrics as M
    rs = np.random.RandomState(0)
    pa, ja = M.Auc(num_thresholds=256), J.Auc(num_thresholds=256)
    pp, jp = M.Precision(), J.Precision()
    pr, jr = M.Recall(), J.Recall()
    pc, jc = M.Accuracy(), J.Accuracy()
    for i in range(4):
        labels = rs.randint(0, 2, (32, 1))
        preds = np.clip(labels * 0.3 + rs.rand(32, 1) * 0.7, 0, 1)
        if i == 3:
            preds = np.concatenate([1 - preds, preds], 1)   # [N, 2] form
        pa.update(torch.from_numpy(preds), torch.from_numpy(labels))
        ja.update(preds, labels)
        p1 = preds if preds.shape[1] == 1 else preds[:, 1:]
        pp.update(torch.from_numpy(p1), labels)
        jp.update(p1, labels)
        pr.update(p1, torch.from_numpy(labels))
        jr.update(p1, labels)
        pc.update(0.25 * i, weight=i + 1)
        jc.update(0.25 * i, weight=i + 1)
    assert pa.eval() == ja.eval() and 0.5 < pa.eval() <= 1.0
    assert pp.eval() == jp.eval() and pr.eval() == jr.eval()
    assert pc.eval() == jc.eval()
    pa.reset()
    assert pa.pos.sum() == 0


def test_ctr_metric_bundle_equals_the_references():
    from paddle_tpu.metrics import ctr_metric_bundle as jb
    from paddle_tpu_torch.metrics import ctr_metric_bundle
    rs = np.random.RandomState(1)
    pred = rs.rand(50, 1).astype(np.float32)
    label = rs.randint(0, 2, (50, 1)).astype(np.float32)
    got = ctr_metric_bundle(t(pred), t(label))
    want = jb(jnp.asarray(pred), jnp.asarray(label))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    # q takes sigmoid of the probability again, as the reference does
    np.testing.assert_allclose(float(got["q"]),
                               float(np.sum(1 / (1 + np.exp(-pred)))),
                               rtol=1e-6)


# ------------------------------------------------ recommender, word2vec

def test_recommender_equals_the_references():
    from paddle_tpu.models.recommender import RecommenderNet as JRec
    from paddle_tpu.models.recommender import rating_loss as jloss
    from paddle_tpu_torch.bridge import export_params
    from paddle_tpu_torch.models.recommender import (RecConfig,
                                                     RecommenderNet,
                                                     rating_loss)
    cfg = RecConfig.tiny()
    m = RecommenderNet(cfg, device="cpu", seed=2)
    rs = np.random.RandomState(3)
    B, L = 6, 5
    args = [rs.randint(0, cfg.num_users, (B,)), rs.randint(0, 2, (B,)),
            rs.randint(0, cfg.num_ages, (B,)), rs.randint(0, cfg.num_jobs,
                                                          (B,)),
            rs.randint(0, cfg.num_movies, (B,)),
            rs.randint(0, cfg.num_categories, (B, L)),
            (rs.rand(B, L) < 0.6).astype(np.float32),
            rs.randint(0, cfg.title_vocab, (B, L)),
            (rs.rand(B, L) < 0.6).astype(np.float32)]
    args[8][0] = 0.0                     # a row with an empty title
    args[6][1] = 0.0                     # and one with no category
    args = [a.astype(np.int32) if a.dtype.kind == "i" else a for a in args]
    rating = (rs.rand(B) * 5).astype(np.float32)
    j = JRec(cfg)

    def jl(p):
        pred = j.apply({"params": p, "state": {}},
                       *[jnp.asarray(a) for a in args])
        return jloss(pred, jnp.asarray(rating)), pred
    (jv, jpred), jg = jax.value_and_grad(jl, has_aux=True)(export_params(m))
    pred = m(*[t(a) for a in args])
    loss = rating_loss(pred, t(rating))
    loss.backward()
    np.testing.assert_allclose(n(pred), np.asarray(jpred), **TOL)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    _close_tree(_grads_of(m), jg)


def test_word2vec_equals_the_references():
    from paddle_tpu.models.word2vec import Word2Vec as JW2V
    from paddle_tpu.models.word2vec import lm_loss as jloss
    from paddle_tpu_torch.bridge import export_params
    from paddle_tpu_torch.models.word2vec import Word2Vec, lm_loss
    m = Word2Vec(vocab_size=64, embed_dim=8, context=4, hidden=16,
                 device="cpu", seed=1)
    w = n(m.embed.weight)
    assert np.abs(w).max() <= 0.5 / 8
    rs = np.random.RandomState(4)
    ctx = rs.randint(0, 64, (10, 4)).astype(np.int32)
    labels = rs.randint(0, 64, (10, 1)).astype(np.int32)
    j = JW2V(vocab_size=64, embed_dim=8, context=4, hidden=16)

    def jl(p):
        logits = j.apply({"params": p, "state": {}}, jnp.asarray(ctx))
        return jloss(logits, jnp.asarray(labels)), logits
    (jv, jlogits), jg = jax.value_and_grad(jl, has_aux=True)(
        export_params(m))
    logits = m(t(ctx))
    loss = lm_loss(logits, t(labels))
    loss.backward()
    np.testing.assert_allclose(n(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss), float(jv), rtol=1e-5)
    _close_tree(_grads_of(m), jg)


# ------------------------------------------------------ the device rule

def _entry_points():
    from paddle_tpu_torch.bridge import load_table_state
    from paddle_tpu_torch.models.ctr import CTRConfig, DeepFM, WideAndDeep
    from paddle_tpu_torch.models.recommender import RecConfig, RecommenderNet
    from paddle_tpu_torch.models.word2vec import Word2Vec
    from paddle_tpu_torch.parallel import (FeatureTable, HostTable,
                                           ShardedHostTable, SparseTable)
    cfg = CTRConfig.tiny()
    ids = np.array([3, 1, 3])
    tbl = SparseTable(10, 2)
    state = {"table": np.zeros((10, 2), np.float32), "step": 0,
             "slots": {}}
    return {
        "DeepFM": lambda **kw: DeepFM(cfg, **kw),
        "DeepFM.sparse": lambda **kw: DeepFM(cfg, sparse_tables=True, **kw),
        "WideAndDeep": lambda **kw: WideAndDeep(cfg, **kw),
        "RecommenderNet": lambda **kw: RecommenderNet(RecConfig.tiny(),
                                                      **kw),
        "Word2Vec": lambda **kw: Word2Vec(64, 8, **kw),
        "SparseTable.init": lambda **kw: tbl.init(**kw),
        "HostTable.pull": lambda **kw: HostTable(10, 2).pull(ids, **kw),
        "FeatureTable.pull": lambda **kw: FeatureTable(2, 4).pull(ids, **kw),
        "ShardedHostTable.pull_local": lambda **kw: ShardedHostTable(
            2, 4, 0, 2).pull_local(ids, **kw),
        "load_table_state": lambda **kw: load_table_state(tbl, state, **kw),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_need_the_card_unless_asked_for_the_cpu(entry):
    from paddle_tpu_torch.core.enforce import EnforceError
    fn = _entry_points()[entry]
    assert fn(device="cpu") is not None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(EnforceError, match="CUDA"):
        fn()
