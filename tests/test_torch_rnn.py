"""The PyTorch port's recurrent stack and beam search against the JAX
reference, on the CPU: the LSTM/GRU cells and scans (lengths, reverse),
the GRU/LSTM layers, ``beam_search_step`` (its ties broken as
``lax.top_k`` breaks them) and ``beam_search_decode``, the cell protocol
(``RNN``, ``BeamSearchDecoder``, ``dynamic_decode``) driven by a custom
attention cell (the test's own copy of ``examples/nmt_seq2seq.py``'s), and
``AttentionSeq2Seq.tiny()``.

The same inputs, made with numpy from a seed, go through both packages;
the weights are the JAX modules', bridged. Tolerances (f32): 1e-5 per op
and per scan (sums in another order); the seq2seq's logits within 1e-4 and
gradients within 1e-4 abs + rel (a scan of 8 steps compounds the per-op
rounding); decoded tokens exactly and beam scores within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def n(x):
    return x.detach().float().numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    from paddle_tpu_torch import bridge
    return bridge.flatten(_np_tree(tree))


def _w(rng, *shape, scale=0.3):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{what}[{i}]")
        return
    np.testing.assert_allclose(n(got), np.asarray(want), err_msg=what, **tol)


# --------------------------------------------------------------- cells

@pytest.mark.parametrize("origin_mode", [False, True])
@pytest.mark.parametrize("biases", [True, False])
def test_gru_cell_matches_jax(rng, origin_mode, biases):
    from paddle_tpu.ops.rnn import gru_cell as jcell
    from paddle_tpu_torch.ops.rnn import gru_cell
    x, h = _w(rng, 5, 7, scale=1), _w(rng, 5, 6, scale=1)
    w_ih, w_hh = _w(rng, 7, 18), _w(rng, 6, 18)
    bs = (_w(rng, 18), _w(rng, 18)) if biases else (None, None)
    want = jcell(*map(jnp.asarray, (x, h, w_ih, w_hh)),
                 *[None if b is None else jnp.asarray(b) for b in bs],
                 origin_mode=origin_mode)
    got = gru_cell(*map(t, (x, h, w_ih, w_hh)),
                   *[None if b is None else t(b) for b in bs],
                   origin_mode=origin_mode)
    _close(got, want)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_cell_matches_jax(rng, forget_bias):
    from paddle_tpu.ops.rnn import lstm_cell as jcell
    from paddle_tpu_torch.ops.rnn import lstm_cell
    args = (_w(rng, 5, 7, scale=1), _w(rng, 5, 6, scale=1),
            _w(rng, 5, 6, scale=1), _w(rng, 7, 24), _w(rng, 6, 24),
            _w(rng, 24))
    want = jcell(*map(jnp.asarray, args), forget_bias=forget_bias)
    got = lstm_cell(*map(t, args), forget_bias=forget_bias)
    _close(got, want)


# --------------------------------------------------------------- scans

LENGTHS = np.array([6, 3, 1, 0], np.int32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
@pytest.mark.parametrize("time_major", [False, True])
def test_gru_scan_matches_jax(rng, reverse, lengths, time_major):
    """Past a row's length its state is frozen; with reverse each row
    starts at its own last valid step (row 3 has none)."""
    from paddle_tpu.ops.rnn import gru as jgru
    from paddle_tpu_torch.ops.rnn import gru
    x = _w(rng, 6, 4, 5, scale=1) if time_major else _w(rng, 4, 6, 5, scale=1)
    h0 = _w(rng, 4, 3, scale=1)
    ws = (_w(rng, 5, 9), _w(rng, 3, 9), _w(rng, 9), _w(rng, 9))
    lj = None if lengths is None else jnp.asarray(lengths)
    want = jgru(jnp.asarray(x), jnp.asarray(h0), *map(jnp.asarray, ws),
                lengths=lj, reverse=reverse, time_major=time_major)
    got = gru(t(x), t(h0), *map(t, ws),
              lengths=None if lengths is None else t(lengths),
              reverse=reverse, time_major=time_major)
    _close(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_lstm_scan_matches_jax(rng, reverse, lengths):
    from paddle_tpu.ops.rnn import lstm as jlstm
    from paddle_tpu_torch.ops.rnn import lstm
    x, h0, c0 = _w(rng, 4, 6, 5, scale=1), _w(rng, 4, 3), _w(rng, 4, 3)
    ws = (_w(rng, 5, 12), _w(rng, 3, 12), _w(rng, 12))
    lj = None if lengths is None else jnp.asarray(lengths)
    want = jlstm(*map(jnp.asarray, (x, h0, c0) + ws), lengths=lj,
                 reverse=reverse)
    got = lstm(*map(t, (x, h0, c0) + ws),
               lengths=None if lengths is None else t(lengths),
               reverse=reverse)
    _close(got, want)


def test_bidirectional_lstm_matches_jax(rng):
    from paddle_tpu.ops.rnn import bidirectional_lstm as jbi
    from paddle_tpu_torch.ops.rnn import bidirectional_lstm
    x, h0, c0 = _w(rng, 4, 6, 5, scale=1), _w(rng, 4, 3), _w(rng, 4, 3)
    pf = (_w(rng, 5, 12), _w(rng, 3, 12), _w(rng, 12))
    pb = (_w(rng, 5, 12), _w(rng, 3, 12), _w(rng, 12))
    want = jbi(*map(jnp.asarray, (x, h0, c0)), tuple(map(jnp.asarray, pf)),
               tuple(map(jnp.asarray, pb)), lengths=jnp.asarray(LENGTHS))
    got = bidirectional_lstm(*map(t, (x, h0, c0)), tuple(map(t, pf)),
                             tuple(map(t, pb)), lengths=t(LENGTHS))
    _close(got, want)


@pytest.mark.parametrize("kind", ["GRU", "LSTM"])
@pytest.mark.parametrize("layers,bidirectional", [(1, False), (2, True),
                                                  (2, False)])
def test_recurrent_layers_match_jax(rng, kind, layers, bidirectional):
    """The multi-step layers with their reference names
    (``w_ih_l{i}d{d}`` ...), lengths and gradients."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import nn as pnn
    jl = getattr(jnn, kind)(5, 4, num_layers=layers,
                            bidirectional=bidirectional)
    variables = jl.init(jax.random.key(2))
    pl = getattr(pnn, kind)(5, 4, num_layers=layers,
                            bidirectional=bidirectional)
    bridge.load_params(pl, _np_tree(variables["params"]))
    x = _w(rng, 4, 6, 5, scale=1)
    want = jl.apply(variables, jnp.asarray(x), lengths=jnp.asarray(LENGTHS))
    xt = t(x).requires_grad_(True)
    got = pl(xt, lengths=t(LENGTHS))
    _close(got, want)
    out = got[0]
    dy = _w(rng, *out.shape, scale=1)
    gx = jax.grad(lambda a: jnp.sum(jl.apply(
        variables, a, lengths=jnp.asarray(LENGTHS))[0] * dy))(jnp.asarray(x))
    (out * t(dy)).sum().backward()
    _close(xt.grad, gx)


# --------------------------------------------------------- beam search

@pytest.mark.parametrize("case", range(4))
def test_beam_search_step_matches_jax_with_ties(rng, case):
    """A vocab smaller than the beam (V = 3, K = 4), beams that were never
    live (score -1e9) and finished beams: candidates at ``pre - 1e9`` tie
    in f32 and are selected; the lower flat index wins, as in
    ``lax.top_k``."""
    from paddle_tpu.ops.rnn import beam_search_step as jstep
    from paddle_tpu_torch.ops.rnn import beam_search_step
    b, k, v, eos = 3, 4, 3, 2
    pre = (-rng.rand(b, k) * 5).astype(np.float32)
    pre[:, 1 + case % 3:] = -1e9
    logp = np.log(rng.dirichlet(np.ones(v), (b, k))).astype(np.float32)
    done = rng.rand(b, k) < 0.5 * (case % 2)
    if case == 3:
        done[:] = True
    want = jstep(jnp.asarray(pre), jnp.asarray(logp), k, eos_id=eos,
                 done=jnp.asarray(done))
    got = beam_search_step(t(pre), t(logp), k, eos_id=eos, done=t(done))
    for name, g, w in zip(("tokens", "scores", "parents"), got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=name)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


def test_top_k_takes_the_lower_index_among_ties():
    from paddle_tpu_torch.ops.rnn import top_k
    x = torch.tensor([[-1e9 + 0.5, 3.0, -1e9 - 2.0, 3.0, -1e9, -1e9]])
    vals, idx = top_k(x, 5)
    assert idx.tolist() == [[1, 3, 0, 2, 4]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _toy_decoder(rng, v, hdim):
    emb, w, u = _w(rng, v, hdim, scale=1), _w(rng, hdim, v, scale=2), _w(
        rng, hdim, hdim)

    def jfn(tokens, h):
        x = jnp.asarray(emb)[tokens]
        h = jnp.tanh(h @ jnp.asarray(u) + x)
        return jax.nn.log_softmax(h @ jnp.asarray(w), -1), h

    def pfn(tokens, h):
        x = t(emb)[tokens.long()]
        h = torch.tanh(h @ t(u) + x)
        return torch.log_softmax(h @ t(w), -1), h

    return jfn, pfn


@pytest.mark.parametrize("v,k", [(7, 3), (3, 4), (2, 8)])
def test_beam_search_decode_matches_jax(rng, v, k):
    """Sequences exactly and scores within 1e-5, through the same
    ``log_probs_fn`` on both sides. A vocab below the beam selects tied
    masked candidates (never-live beams, and finished beams' non-eos
    tokens) at the first steps; at V = 2, K = 8 they stay in the final
    beams."""
    from paddle_tpu.ops.rnn import beam_search_decode as jdec
    from paddle_tpu_torch.ops.rnn import beam_search_decode
    b, hdim, bos, eos, max_len = 2, 5, 0, 1, 6
    jfn, pfn = _toy_decoder(rng, v, hdim)
    h0 = np.repeat(_w(rng, b, hdim, scale=1), k, axis=0)
    js, jsc = jdec(jfn, jnp.asarray(h0), bos, eos, k, max_len, b, v)
    ps, psc = beam_search_decode(pfn, t(h0), bos, eos, k, max_len, b, v)
    assert tuple(ps.shape) == (b, k, max_len)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    _close(psc, jsc)


# ------------------------------------------- the protocol, custom cell

SEQ, VOCAB, BOS, EOS = 6, 20, 1, 2


def _jax_seq2seq():
    """The example's model (examples/nmt_seq2seq.py), JAX side: a GRU
    encoder (nn.RNN) and a custom attention cell."""
    from paddle_tpu import nn as jnn

    class AttentionGRUCell(jnn.RNNCell):
        def __init__(self, emb_dim, hidden):
            super().__init__()
            self.hidden = hidden
            self.gru = jnn.GRUCell(emb_dim + hidden, hidden)
            self.attn_q = jnn.Linear(hidden, hidden, bias=False)

        @property
        def state_shape(self):
            return ((self.hidden,), (SEQ, self.hidden))

        def forward(self, inputs, states):
            h, enc = states
            q = self.attn_q(h)
            w = jax.nn.softmax(jnp.einsum("nh,nth->nt", q, enc), -1)
            ctx = jnp.einsum("nt,nth->nh", w, enc)
            out, h = self.gru(jnp.concatenate([inputs, ctx], -1), h)
            return out, (h, enc)

    class Seq2Seq(jnn.Module):
        def __init__(self, emb_dim=8, hidden=12):
            super().__init__()
            self.src_emb = jnn.Embedding(VOCAB, emb_dim)
            self.tgt_emb = jnn.Embedding(VOCAB, emb_dim)
            self.encoder = jnn.RNN(jnn.GRUCell(emb_dim, hidden))
            self.cell = AttentionGRUCell(emb_dim, hidden)
            self.proj = jnn.Linear(hidden, VOCAB)

        def encode(self, src, lengths=None):
            return self.encoder(self.src_emb(src), lengths=lengths)

        def forward(self, src, tgt_in):
            enc, h = self.encode(src)
            xs = jnp.moveaxis(self.tgt_emb(tgt_in), 1, 0)

            def step(carry, x_t):
                out, carry = self.cell(x_t, carry)
                return carry, out

            _, outs = jax.lax.scan(step, (h, enc), xs)
            return self.proj(jnp.moveaxis(outs, 0, 1))

    return Seq2Seq()


def _port_seq2seq():
    """The same model on the port's protocol."""
    from paddle_tpu_torch import nn as pnn

    class AttentionGRUCell(pnn.RNNCell):
        def __init__(self, emb_dim, hidden):
            super().__init__()
            self.hidden = hidden
            self.gru = pnn.GRUCell(emb_dim + hidden, hidden)
            self.attn_q = pnn.Linear(hidden, hidden, bias=False)

        @property
        def state_shape(self):
            return ((self.hidden,), (SEQ, self.hidden))

        def forward(self, inputs, states):
            h, enc = states
            q = self.attn_q(h)
            w = torch.softmax(torch.einsum("nh,nth->nt", q, enc), -1)
            ctx = torch.einsum("nt,nth->nh", w, enc)
            out, h = self.gru(torch.cat([inputs, ctx], -1), h)
            return out, (h, enc)

    class Seq2Seq(torch.nn.Module):
        def __init__(self, emb_dim=8, hidden=12):
            super().__init__()
            self.src_emb = pnn.Embedding(VOCAB, emb_dim)
            self.tgt_emb = pnn.Embedding(VOCAB, emb_dim)
            self.encoder = pnn.RNN(pnn.GRUCell(emb_dim, hidden))
            self.cell = AttentionGRUCell(emb_dim, hidden)
            self.proj = pnn.Linear(hidden, VOCAB)

        def encode(self, src, lengths=None):
            return self.encoder(self.src_emb(src), lengths=lengths)

        def forward(self, src, tgt_in):
            enc, h = self.encode(src)
            x = self.tgt_emb(tgt_in)
            states, outs = (h, enc), []
            for i in range(x.shape[1]):
                out, states = self.cell(x[:, i], states)
                outs.append(out)
            return self.proj(torch.stack(outs, 1))

    return Seq2Seq()


@pytest.fixture
def seq2seq_pair():
    from paddle_tpu_torch import bridge
    jm = _jax_seq2seq()
    params = jm.init(jax.random.key(4))["params"]
    pm = _port_seq2seq()
    bridge.load_params(pm, _np_tree(params))
    return jm, params, pm


def test_rnn_driver_with_lengths_and_reverse_matches_jax(rng):
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch import nn as pnn
    lengths = np.array([5, 2, 0], np.int32)
    x = _w(rng, 3, 5, 4, scale=1)
    for cell, reverse in (("GRUCell", False), ("LSTMCell", True)):
        jr = jnn.RNN(getattr(jnn, cell)(4, 6), is_reverse=reverse)
        variables = jr.init(jax.random.key(1))
        pr = pnn.RNN(getattr(pnn, cell)(4, 6), is_reverse=reverse)
        bridge.load_params(pr, _np_tree(variables["params"]))
        want = jr.apply(variables, jnp.asarray(x),
                        lengths=jnp.asarray(lengths))
        got = pr(t(x), lengths=t(lengths))
        _close(got, want, what=cell)


def test_custom_cell_teacher_forced_logits_match_jax(rng, seq2seq_pair):
    jm, params, pm = seq2seq_pair
    src = rng.randint(3, VOCAB, (4, SEQ)).astype(np.int32)
    tgt_in = rng.randint(3, VOCAB, (4, SEQ)).astype(np.int32)
    want = jm.apply({"params": params, "state": {}}, jnp.asarray(src),
                    jnp.asarray(tgt_in))
    with torch.no_grad():
        got = pm(t(src), t(tgt_in))
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("beam", [3, 1])
def test_beam_search_decoder_with_a_custom_cell_matches_jax(
        rng, seq2seq_pair, beam):
    """``BeamSearchDecoder`` over the custom cell through
    ``dynamic_decode`` (with the backtrace and ``return_length``):
    sequences and lengths exactly, scores within 1e-5."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as pnn
    jm, params, pm = seq2seq_pair
    src = rng.randint(3, VOCAB, (5, SEQ)).astype(np.int32)
    full = {"params": params, "state": {}}
    enc, h = jm.apply(full, jnp.asarray(src), method="encode")
    dec = jnn.BeamSearchDecoder(
        jm.cell, start_token=BOS, end_token=EOS, beam_size=beam,
        embedding_fn=lambda tok: jm.apply(
            full, tok, method=lambda x: jm.tgt_emb(x)),
        output_fn=lambda out: jm.apply(full, out,
                                       method=lambda o: jm.proj(o)),
        vocab_size=VOCAB, cell_variables={"params": params["cell"],
                                          "state": {}})
    js, jsc, jlen = jnn.dynamic_decode(dec, (h, enc), max_step_num=SEQ + 2,
                                       return_length=True)
    with torch.no_grad():
        penc, ph = pm.encode(t(src))
        pdec = pnn.BeamSearchDecoder(
            pm.cell, start_token=BOS, end_token=EOS, beam_size=beam,
            embedding_fn=pm.tgt_emb, output_fn=pm.proj, vocab_size=VOCAB)
        ps, psc, plen = pnn.dynamic_decode(pdec, (ph, penc),
                                           max_step_num=SEQ + 2,
                                           return_length=True)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
    _close(psc, jsc)


def test_cell_initial_states_match_jax():
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as pnn
    for cell in ("GRUCell", "LSTMCell"):
        want = getattr(jnn, cell)(3, 5).get_initial_states(2)
        got = getattr(pnn, cell)(3, 5).get_initial_states(2)
        _close(got, want, what=cell)


# ------------------------------------------------------------- seq2seq

def _s2s_pair(seed=0):
    from paddle_tpu.models.seq2seq import AttentionSeq2Seq as JM
    from paddle_tpu.models.seq2seq import Seq2SeqConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.seq2seq import AttentionSeq2Seq as PM
    from paddle_tpu_torch.models.seq2seq import Seq2SeqConfig as PC
    jm = JM(JC.tiny())
    params = jm.init(jax.random.key(seed))["params"]
    pm = PM(PC.tiny(), device="cpu", seed=seed + 3)
    bridge.load_params(pm, _np_tree(params))
    return jm, params, pm


def _s2s_batch(rng, b=4, s=9, tt=8):
    src = rng.randint(3, 64, (b, s)).astype(np.int32)
    lengths = np.array([9, 5, 1, 7][:b], np.int32)
    for i, ln in enumerate(lengths):
        src[i, ln:] = 0
    tgt = rng.randint(3, 64, (b, tt)).astype(np.int32)
    tgt_len = np.array([8, 6, 3, 1][:b], np.int32)
    return src, lengths, tgt, tgt_len


def test_seq2seq_logits_loss_and_grads_match_jax(rng):
    from paddle_tpu.models.seq2seq import nmt_loss as jax_nmt
    from paddle_tpu_torch.models.seq2seq import nmt_loss
    jm, params, pm = _s2s_pair()
    src, lengths, tgt, tgt_len = _s2s_batch(rng)
    labels = np.roll(tgt, -1, axis=1)

    def jloss(p):
        logits = jm.apply({"params": p, "state": {}}, jnp.asarray(src),
                          jnp.asarray(lengths), jnp.asarray(tgt))
        return jax_nmt(logits, jnp.asarray(labels),
                       jnp.asarray(tgt_len)), logits

    (jl, jlog), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    logits = pm(t(src), t(lengths), t(tgt))
    _close(logits, jlog, LOGIT_TOL)
    pl = nmt_loss(logits, t(labels), t(tgt_len))
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), **TOL)
    want = _flat(jg)
    got = {name: p.grad for name, p in pm.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(n(g), want[name], err_msg=name,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_seq2seq_greedy_and_beam_decode_match_jax(seed):
    rng = np.random.RandomState(seed)
    jm, params, pm = _s2s_pair(seed)
    src, lengths, _, _ = _s2s_batch(rng)
    full = {"params": params, "state": {}}
    bos, eos, max_len = 1, 2, 10
    jg = jm.apply(full, jnp.asarray(src), jnp.asarray(lengths), bos, eos,
                  max_len, method="greedy_decode")
    js, jsc = jm.apply(full, jnp.asarray(src), jnp.asarray(lengths), bos,
                       eos, 4, max_len, method="beam_decode")
    with torch.no_grad():
        pg = pm.greedy_decode(t(src), t(lengths), bos, eos, max_len)
        ps, psc = pm.beam_decode(t(src), t(lengths), bos, eos, 4, max_len)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    _close(psc, jsc)


def test_seq2seq_bridge_names_match_jax_and_defaults_to_the_card():
    from paddle_tpu.models.seq2seq import AttentionSeq2Seq as JM
    from paddle_tpu.models.seq2seq import Seq2SeqConfig as JC
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.seq2seq import (AttentionSeq2Seq,
                                                 Seq2SeqConfig)
    want = _flat(JM(JC.tiny()).init(jax.random.key(0))["params"])
    pm = AttentionSeq2Seq(Seq2SeqConfig.tiny(), device="cpu")
    got = bridge.flatten(bridge.export_params(pm))
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
