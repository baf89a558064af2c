"""The port's scan over layers with remat (``paddle_tpu_torch/nn/scan.py``,
``scan_layers`` / ``remat`` of GPT, BERT and ERNIE) and the layer-tree
conversions of ``io/checkpoint.py`` against the JAX package's.

A scan model takes the JAX package's stacked tree as it is. Its logits
and losses are held to the JAX scan model's at 1e-4 and its gradients at
1e-3 relative L2; against the port's unrolled model of the same seed
(the same weights, the same ops in the same order) and across the three
remat policies (a recomputation repeats the same ops), logits, losses
and gradients are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
POLICIES = ("nothing", "dots_saveable", "full")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_tree(tree))


def _grad_errs(pm, jgrads):
    """Each parameter's gradient error relative to the larger of its own
    norm and 1e-3 of the largest (a gradient 0 in exact arithmetic, the
    key bias's, is rounding noise)."""
    want = _flat(jgrads)
    top = max(np.linalg.norm(w) for w in want.values())
    return {n: np.linalg.norm(_np(p.grad) - want[n])
            / max(np.linalg.norm(want[n]), 1e-3 * top)
            for n, p in pm.named_parameters()}


GPT_KW = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
              intermediate_size=128, max_position=64, dropout=0.0)


@pytest.mark.parametrize("remat", POLICIES)
def test_scan_gpt_matches_jax_scan_model(rng, remat):
    from paddle_tpu.models.gpt import GPT as JGPT
    from paddle_tpu.models.gpt import GPTConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    kw = dict(GPT_KW, scan_layers=True, remat=remat)
    jm = JGPT(JC(**kw))
    params = jm.init(jax.random.key(0))["params"]
    assert set(params["blocks"]) == {"layer"}
    pm = GPT(GPTConfig(**kw), device="cpu", seed=5)
    assert tuple(pm.blocks.layer.fc1.weight.shape) == (3, 64, 128)
    bridge.load_params(pm, _tree(params))
    ids = rng.randint(0, 256, (2, 24)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params, "state": {}},
                              jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_allclose(_np(pm(torch.from_numpy(ids))), ref,
                                   **LOGIT_TOL)
    jl, jg = jax.value_and_grad(lambda p: jm.apply(
        {"params": p, "state": {}}, jnp.asarray(ids), method="loss"))(params)
    loss = pm.loss(torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOGIT_TOL)
    errs = _grad_errs(pm, jg)
    assert max(errs.values()) < 1e-3, max(errs.items(), key=lambda e: e[1])
    back = bridge.flatten(bridge.export_params(pm))
    for name, val in _flat(params).items():
        np.testing.assert_array_equal(back[name], val)


def _bert_batch(rng, b=2, t=20, m=4, vocab=200):
    ids = rng.randint(0, vocab, (b, t)).astype(np.int32)
    att = np.ones((b, t), np.float32)
    att[0, 15:] = 0.0
    types = np.zeros((b, t), np.int32)
    types[:, 10:] = 1
    pos = np.stack([np.sort(rng.choice(15, m, replace=False))
                    for _ in range(b)]).astype(np.int32)
    return (ids, rng.randint(0, vocab, (b, m)).astype(np.int32),
            rng.randint(0, 2, (b,)).astype(np.int32),
            np.ones((b, m), np.float32), types, att, pos)


BERT_KW = dict(vocab_size=200, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=64, dropout=0.0)


@pytest.mark.parametrize("model", ["bert", "ernie"])
def test_scan_bert_and_ernie_match_jax_scan_models(rng, model):
    from paddle_tpu_torch import bridge
    if model == "bert":
        from paddle_tpu.models.bert import BertConfig as JC
        from paddle_tpu.models.bert import BertForPretraining as JM
        from paddle_tpu_torch.models.bert import BertConfig as PC
        from paddle_tpu_torch.models.bert import BertForPretraining as PM
    else:
        from paddle_tpu.models.ernie import ErnieConfig as JC
        from paddle_tpu.models.ernie import ErnieForPretraining as JM
        from paddle_tpu_torch.models.ernie import ErnieConfig as PC
        from paddle_tpu_torch.models.ernie import ErnieForPretraining as PM
    kw = dict(BERT_KW, scan_layers=True, remat="full")
    jm = JM(JC(**kw))
    params = jm.init(jax.random.key(1))["params"]
    pm = PM(PC(**kw), device="cpu", seed=2)
    bridge.load_params(pm, _tree(params))
    ids, ml, nl, mm, types, att, pos = _bert_batch(rng)
    j = jnp.asarray
    jl, jn = jm.apply({"params": params, "state": {}}, j(ids), j(types),
                      j(att), j(pos))
    jv, jg = jax.value_and_grad(lambda p: jm.apply(
        {"params": p, "state": {}}, j(ids), j(ml), j(nl), j(mm),
        token_type_ids=j(types), attention_mask=j(att), mask_positions=j(pos),
        method="loss"))(params)
    t = torch.from_numpy
    with torch.no_grad():
        pl, pn = pm(t(ids), t(types), t(att), t(pos))
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(_np(pn), np.asarray(jn), **LOGIT_TOL)
    loss = pm.loss(t(ids), t(ml), t(nl), t(mm), token_type_ids=t(types),
                   attention_mask=t(att), mask_positions=t(pos))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), **LOGIT_TOL)
    errs = _grad_errs(pm, jg)
    assert max(errs.values()) < 1e-3, max(errs.items(), key=lambda e: e[1])


def _gpt(scan, remat=None, dropout=0.1, seed=0):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(**dict(GPT_KW, dropout=dropout, scan_layers=scan,
                           remat=remat))
    return GPT(cfg, device="cpu", seed=seed).train()


def _stacked_grads(model):
    if model.cfg.scan_layers:
        return {n: p.grad.clone() for n, p in model.named_parameters()}
    out = {}
    for n, p in model.named_parameters():
        if n.startswith("blocks."):
            _, i, rest = n.split(".", 2)
            out.setdefault(f"blocks.layer.{rest}", {})[int(i)] = p.grad
        else:
            out[n] = p.grad.clone()
    return {n: torch.stack([g[i] for i in range(len(g))])
            if isinstance(g, dict) else g for n, g in out.items()}


def test_remat_policies_give_the_unrolled_models_loss_and_gradients(rng):
    """With dropout on (masks from the model's generator, replayed in a
    recomputation), each policy's loss and gradients equal the unrolled
    model's of the same seed; a recomputing policy runs each layer's
    attention twice a step, ``nothing`` once."""
    ids = torch.from_numpy(rng.randint(0, 256, (2, 24)).astype(np.int32))
    unrolled = _gpt(False)
    want_loss = unrolled.loss(ids)
    want_loss.backward()
    want = _stacked_grads(unrolled)
    for policy in POLICIES:
        model = _gpt(True, policy)
        calls = []
        model.blocks.layer.attn.register_forward_hook(
            lambda *a: calls.append(1))
        loss = model.loss(ids)
        loss.backward()
        assert torch.equal(loss, want_loss), policy
        got = _stacked_grads(model)
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), (policy, name)
        layers = GPT_KW["num_layers"]
        assert len(calls) == (layers if policy == "nothing" else 2 * layers)


def test_remat_bf16_amp_step_equals_the_unrolled_step(rng):
    """One amp.decorate(Adam) bf16 step of a scan model under ``full``
    and ``dots_saveable`` remat, against the unrolled model's: the loss
    and every updated parameter."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Adam
    ids = torch.from_numpy(rng.randint(0, 256, (2, 24)).astype(np.int32))

    def step(model):
        opt = amp.decorate(Adam(model.parameters(), 1e-3), amp.bf16_policy())
        loss = opt.minimize(model, lambda m, x: m.loss(x), ids)
        return loss, _stacked_params(model)
    want_loss, want = step(_gpt(False, dropout=0.0))
    for policy in ("full", "dots_saveable"):
        loss, got = step(_gpt(True, policy, dropout=0.0))
        assert torch.equal(loss, want_loss), policy
        for name in want:
            assert torch.equal(got[name], want[name]), (policy, name)


def _stacked_params(model):
    if model.cfg.scan_layers:
        return {n: p.detach().clone() for n, p in model.named_parameters()}
    out = {}
    for n, p in model.named_parameters():
        if n.startswith("blocks."):
            _, i, rest = n.split(".", 2)
            out.setdefault(f"blocks.layer.{rest}", []).append(p.detach())
        else:
            out[n] = p.detach().clone()
    return {n: torch.stack(v) if isinstance(v, list) else v
            for n, v in out.items()}


def test_bert_remat_policies_equal_and_refusals(rng):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    ids, ml, nl, mm, types, att, pos = map(torch.from_numpy,
                                           _bert_batch(rng))
    grads = {}
    for policy in POLICIES:
        cfg = BertConfig(**dict(BERT_KW, dropout=0.1, scan_layers=True,
                                remat=policy))
        m = BertForPretraining(cfg, device="cpu", seed=4).train()
        loss = m.loss(ids, ml, nl, mm, token_type_ids=types,
                      attention_mask=att, mask_positions=pos)
        loss.backward()
        grads[policy] = (loss.detach(), {n: p.grad for n, p
                                         in m.named_parameters()})
    for policy in POLICIES[1:]:
        assert torch.equal(grads[policy][0], grads["nothing"][0])
        for n, g in grads["nothing"][1].items():
            assert torch.equal(grads[policy][1][n], g), (policy, n)
    with pytest.raises(EnforceError):
        BertForPretraining(BertConfig(**dict(BERT_KW, remat="most")),
                           device="cpu")


def test_stack_and_unstack_layer_tree_match_jax():
    from paddle_tpu.io.checkpoint import stack_layer_tree as jstack
    from paddle_tpu.io.checkpoint import unstack_layer_tree as junstack
    from paddle_tpu.models.gpt import GPT as JGPT
    from paddle_tpu.models.gpt import GPTConfig as JC
    from paddle_tpu_torch.io import stack_layer_tree, unstack_layer_tree
    tree = _tree(JGPT(JC(**GPT_KW)).init(jax.random.key(2))["params"])
    want = _flat(jstack(tree))
    got = stack_layer_tree(tree)
    assert sorted(_flat(got)) == sorted(want)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k])
    back = unstack_layer_tree(got)
    want_back = _flat(junstack(jstack(tree)))
    assert sorted(_flat(back)) == sorted(want_back) == sorted(_flat(tree))
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, want_back[k])
    # torch leaves: the port's own unrolled export stacks into the scan
    # model's parameters, and a scan model's export unstacks into the
    # decoder's
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    unrolled = _gpt(False, dropout=0.0)
    scan = _gpt(True, "full", dropout=0.0, seed=9)
    bridge.load_params(scan, stack_layer_tree(
        bridge.export_params(unrolled)))
    decoder = GPTDecoder(GPTConfig(**dict(GPT_KW, dropout=0.0)),
                         device="cpu", seed=11)
    bridge.load_params(decoder,
                       unstack_layer_tree(bridge.export_params(scan)))
    ids = torch.from_numpy(np.arange(20, dtype=np.int32)[None] % 256)
    with torch.no_grad():
        a, b = unrolled.eval()(ids), scan.eval()(ids)
        c = decoder(ids)
    assert torch.equal(a, b) and torch.equal(a, c)
    t_tree = {"0": {"w": torch.ones(2, 3)}, "1": {"w": torch.zeros(2, 3)}}
    st = stack_layer_tree(t_tree)
    assert tuple(st["layer"]["w"].shape) == (2, 2, 3)
    assert torch.equal(unstack_layer_tree(st)["1"]["w"], t_tree["1"]["w"])


def test_decoder_refuses_scan_layers():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    cfg = GPTConfig.tiny()
    cfg.scan_layers = True
    with pytest.raises(EnforceError, match="unstack_layer_tree"):
        GPTDecoder(cfg, device="cpu")
