"""The book's sequence models in the port against the JAX reference on the
CPU: ``TextCNNSentiment``, ``StackedLSTMSentiment`` (3 and 2 stacks) and
``BiLstmCrfTagger`` (one layer; two layers with two extra feature
embeddings) at tiny sizes, with the port's weights carried to JAX by the
bridge: logits and loss, every gradient, the tagger's Viterbi paths; the
bridge loading each JAX model's own params with no key left over; padding
invariance; and the training cases of ``tests/test_models_book.py`` (the
loss falls, the tagger learns its tag mapping). Batches are made with
numpy from a seed; dropout is 0.

Tolerances: logits and loss within 1e-4 (stacked f32 recurrences summed
in another order), gradients within 1e-3 relative L2, decoded paths
exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import sentiment as JS
from paddle_tpu.models import tagging as JT
from paddle_tpu_torch.bridge import export_params, flatten, load_params
from paddle_tpu_torch.models import sentiment as PS
from paddle_tpu_torch.models import tagging as PT

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-3


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().cpu().numpy()


def grads_close(model, jgrads):
    """Every port gradient within GRAD_TOL relative L2 of JAX's (each
    relative to the larger of its own norm and 1e-3 of the largest)."""
    want = {k: np.asarray(v) for k, v in flatten(jgrads).items()}
    got = {k: n(p.grad) for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    top = max(np.linalg.norm(v) for v in want.values())
    for k, v in want.items():
        err = np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), 1e-3 * top)
        assert err < GRAD_TOL, (k, err)


def sentiment_batch(cfg, seed, B=6, T=10):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, cfg.vocab_size, (B, T)).astype(np.int32)
    lengths = rs.randint(2, T + 1, B).astype(np.int32)
    lengths[0] = T
    labels = rs.randint(0, cfg.num_classes, (B, 1)).astype(np.int32)
    return ids, lengths, labels


SENTIMENT = {
    "cnn": (PS.TextCNNSentiment, JS.TextCNNSentiment, {}),
    "lstm3": (PS.StackedLSTMSentiment, JS.StackedLSTMSentiment, {}),
    "lstm2": (PS.StackedLSTMSentiment, JS.StackedLSTMSentiment,
              {"stacked_num": 2}),
}


@pytest.mark.parametrize("name", sorted(SENTIMENT))
def test_sentiment_logits_loss_and_gradients_equal_jaxs(name):
    pcls, jcls, kw = SENTIMENT[name]
    cfg = PS.SentimentConfig.tiny()
    model = pcls(cfg, device="cpu", seed=3, **kw)
    ref = jcls(JS.SentimentConfig.tiny(), **kw)
    ids, lengths, labels = sentiment_batch(cfg, 1)

    def jl(p):
        logits = ref.apply({"params": p, "state": {}}, jnp.asarray(ids),
                           jnp.asarray(lengths))
        return JS.sentiment_loss(logits, jnp.asarray(labels)), logits
    (jloss, jlogits), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        export_params(model))
    logits = model(t(ids), t(lengths))
    loss = PS.sentiment_loss(logits, t(labels))
    loss.backward()
    np.testing.assert_allclose(n(logits), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads_close(model, jg)
    # no lengths: every row full, as in the reference
    np.testing.assert_allclose(
        n(model(t(ids))), np.asarray(ref.apply(
            {"params": export_params(model), "state": {}},
            jnp.asarray(ids))), **TOL)


def tagger_configs():
    tiny = PT.TaggerConfig.tiny()
    deep = PT.TaggerConfig(vocab_size=64, num_tags=5, embed_dim=8, hidden=12,
                           num_lstm_layers=2, num_extra_features=2)
    return {"tiny": tiny, "deep": deep}


def tagger_batch(cfg, seed, B=6, T=9):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = (toks % cfg.num_tags).astype(np.int32)
    lengths = rs.randint(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    extra = (rs.randint(0, cfg.vocab_size, (B, T, cfg.num_extra_features))
             .astype(np.int32) if cfg.num_extra_features else None)
    return toks, lengths, labels, extra


@pytest.mark.parametrize("name", ["tiny", "deep"])
def test_tagger_loss_gradients_and_paths_equal_jaxs(name):
    cfg = tagger_configs()[name]
    model = PT.BiLstmCrfTagger(cfg, device="cpu", seed=4)
    ref = JT.BiLstmCrfTagger(JT.TaggerConfig(**vars(cfg)))
    toks, lengths, labels, extra = tagger_batch(cfg, 2)
    jx = None if extra is None else jnp.asarray(extra)
    px = None if extra is None else t(extra)

    def jl(p):
        return ref.apply({"params": p, "state": {}}, jnp.asarray(toks),
                         jnp.asarray(lengths), labels=jnp.asarray(labels),
                         extra_ids=jx)
    params = export_params(model)
    jloss, jg = jax.jit(jax.value_and_grad(jl))(params)
    loss = model(t(toks), t(lengths), labels=t(labels), extra_ids=px)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads_close(model, jg)
    jem, jpath = jax.jit(lambda p: (
        ref.apply({"params": p, "state": {}}, jnp.asarray(toks),
                  jnp.asarray(lengths), jx, method=ref.emissions),
        ref.apply({"params": p, "state": {}}, jnp.asarray(toks),
                  jnp.asarray(lengths), extra_ids=jx)))(params)
    with torch.no_grad():
        em = model.emissions(t(toks), t(lengths), px)
        path = model(t(toks), t(lengths), extra_ids=px)
    np.testing.assert_allclose(n(em), np.asarray(jem), **TOL)
    np.testing.assert_array_equal(n(path), np.asarray(jpath))


def _jax_models():
    return {
        "cnn": (JS.TextCNNSentiment(JS.SentimentConfig.tiny()),
                lambda: PS.TextCNNSentiment(PS.SentimentConfig.tiny(),
                                            device="cpu")),
        "lstm3": (JS.StackedLSTMSentiment(JS.SentimentConfig.tiny()),
                  lambda: PS.StackedLSTMSentiment(PS.SentimentConfig.tiny(),
                                                  device="cpu")),
        "tagger": (JT.BiLstmCrfTagger(JT.TaggerConfig(
            **vars(tagger_configs()["deep"]))),
            lambda: PT.BiLstmCrfTagger(tagger_configs()["deep"],
                                       device="cpu")),
    }


@pytest.mark.parametrize("name", ["cnn", "lstm3", "tagger"])
def test_bridge_loads_the_jax_models_params(name):
    """``load_params`` takes each JAX model's own params with no key left
    over (it raises on a missing or extra leaf), and the port then gives
    the reference's outputs."""
    ref, make = _jax_models()[name]
    v = ref.init(jax.random.key(5))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    model = load_params(make(), params)
    assert sorted(dict(model.named_parameters())) == sorted(flatten(params))
    if name == "tagger":
        cfg = tagger_configs()["deep"]
        toks, lengths, _, extra = tagger_batch(cfg, 6)
        want = jax.jit(lambda v: ref.apply(
            v, jnp.asarray(toks), jnp.asarray(lengths),
            extra_ids=jnp.asarray(extra)))(v)
        with torch.no_grad():
            got = model(t(toks), t(lengths), extra_ids=t(extra))
        np.testing.assert_array_equal(n(got), np.asarray(want))
    else:
        ids, lengths, _ = sentiment_batch(PS.SentimentConfig.tiny(), 6)
        want = jax.jit(lambda v: ref.apply(v, jnp.asarray(ids),
                                           jnp.asarray(lengths)))(v)
        with torch.no_grad():
            got = model(t(ids), t(lengths))
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["cnn", "lstm3", "tagger"])
def test_padding_content_changes_nothing(name):
    """ref: ``tests/test_models_book.py:284`` — tokens past a row's length
    leave the logits (the tagger's emissions and paths on the valid
    positions) as they were."""
    rs = np.random.RandomState(2)
    ids = rs.randint(1, 64, (2, 10)).astype(np.int32)
    lengths = np.array([6, 10], np.int32)
    ids2 = ids.copy()
    ids2[0, 6:] = 7
    with torch.no_grad():
        if name == "tagger":
            model = PT.BiLstmCrfTagger(PT.TaggerConfig.tiny(), device="cpu")
            e1 = model.emissions(t(ids), t(lengths))
            e2 = model.emissions(t(ids2), t(lengths))
            np.testing.assert_allclose(n(e1)[0, :6], n(e2)[0, :6], atol=1e-6)
            np.testing.assert_array_equal(n(model(t(ids), t(lengths))),
                                          n(model(t(ids2), t(lengths))))
            return
        cls = (PS.TextCNNSentiment if name == "cnn"
               else PS.StackedLSTMSentiment)
        model = cls(PS.SentimentConfig.tiny(), device="cpu", seed=1)
        np.testing.assert_allclose(n(model(t(ids), t(lengths))),
                                   n(model(t(ids2), t(lengths))), atol=1e-6)


@pytest.mark.parametrize("name", ["cnn", "lstm3"])
def test_sentiment_nets_train(name):
    """ref: ``tests/test_models_book.py:263`` — 12 Adam(5e-3) steps on one
    batch of 8 x 12; the loss falls."""
    from paddle_tpu_torch.optimizer import Adam
    pcls, _, kw = SENTIMENT[name]
    cfg = PS.SentimentConfig.tiny()
    model = pcls(cfg, device="cpu", seed=0, **kw)
    rs = np.random.RandomState(0)
    ids = t(rs.randint(1, cfg.vocab_size, (8, 12)))
    lengths = t(rs.randint(4, 13, (8,)))
    labels = t(rs.randint(0, 2, (8, 1)))
    opt = Adam(model.parameters(), 5e-3)
    losses = [float(opt.minimize(
        model, lambda m, *a: PS.sentiment_loss(m(a[0], a[1]), a[2]), ids,
        lengths, labels)) for _ in range(12)]
    assert losses[-1] < losses[0], losses


def test_tagger_learns_identity_tags():
    """ref: ``tests/test_models_book.py:76`` — 25 Adam(0.1) steps on
    ``labels = tokens % num_tags``: the loss falls below 0.8 of the first
    and the decoded paths reach over half of the labels."""
    from paddle_tpu_torch.optimizer import Adam
    cfg = PT.TaggerConfig.tiny()
    model = PT.BiLstmCrfTagger(cfg, device="cpu", seed=1)
    rs = np.random.RandomState(1)
    B, T = 8, 7
    toks = rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = toks % cfg.num_tags
    lengths = rs.randint(3, T + 1, B).astype(np.int32)
    opt = Adam(model.parameters(), 0.1)
    losses = [float(opt.minimize(
        model, lambda m, a, b, c: m(a, b, labels=c), t(toks), t(lengths),
        t(labels))) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.8, losses
    with torch.no_grad():
        path = n(model(t(toks), t(lengths)))
    mask = np.arange(T)[None] < lengths[:, None]
    assert (path == labels)[mask].mean() > 0.5
