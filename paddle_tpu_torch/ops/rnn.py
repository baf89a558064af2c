"""Recurrent ops: LSTM/GRU cells, multi-step RNNs over padded batches, and
static-shape beam search (ref: ``paddle_tpu/ops/rnn.py``).

The reference scans each recurrence with ``lax.scan``; here it is a Python
loop over time steps, each step one fused ``[4H]`` / ``[3H]`` gate product
per operand. Variable length is the reference's mask: past a row's length
its state is frozen (see :func:`_masked_scan`). The reference writes no
Pallas kernel for any of this (XLA fuses it), so neither does the port.

Beam search selects with :func:`top_k`, which breaks ties as ``lax.top_k``
does (the lower index first): masked candidates sit at ``score - 1e9``,
where f32 rounding makes many of them equal.
"""

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops.nn import matmul
from paddle_tpu_torch.ops.tensor_ops import top_k  # noqa: F401

#: the score of a masked candidate (the reference's ``neg_inf``)
NEG_INF = -1e9


def tree_map(fn, *trees):
    """``fn`` over the tensors of matching tuple/list/dict trees (a
    state of an RNN cell: a tensor, or ``(h, c)``, or any nesting)."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


@register_op("lstm_cell")
def lstm_cell(x, h, c, w_ih, w_hh, b=None, forget_bias=0.0):
    """One LSTM step (ref: ``ops/rnn.py:23``). x ``[B, I]``, h/c ``[B, H]``,
    w_ih ``[I, 4H]``, w_hh ``[H, 4H]``, b ``[4H]``; gate order i, f, g,
    o. Returns ``(h, c)``."""
    gates = matmul(x, w_ih) + matmul(h, w_hh)
    if b is not None:
        gates = gates + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = A.sigmoid(i)
    f = A.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = A.sigmoid(o)
    new_c = f * c + i * g
    return o * torch.tanh(new_c), new_c


@register_op("gru_cell")
def gru_cell(x, h, w_ih, w_hh, b_ih=None, b_hh=None, origin_mode=False):
    """One GRU step (ref: ``ops/rnn.py:40``). x ``[B, I]``, h ``[B, H]``,
    w_ih ``[I, 3H]``, w_hh ``[H, 3H]``; gate order r, z, n. ``origin_mode``
    False (the reference's default) gives ``z * n + (1 - z) * h``, True
    gives ``(1 - z) * n + z * h``."""
    gi = matmul(x, w_ih)
    gh = matmul(h, w_hh)
    if b_ih is not None:
        gi = gi + b_ih
    if b_hh is not None:
        gh = gh + b_hh
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = A.sigmoid(i_r + h_r)
    z = A.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    if origin_mode:
        return (1.0 - z) * n + z * h
    return z * n + (1.0 - z) * h


def _masked_scan(cell_step, xs, init, lengths, reverse=False):
    """``cell_step(carry, x_t) -> carry`` over xs ``[T, B, ...]`` with
    per-row lengths (ref: ``ops/rnn.py:62``). At step t a row whose
    ``t >= lengths[row]`` keeps its carry, so a forward scan freezes each
    row's state after its last valid step, and a reverse scan (from
    ``T - 1`` down) holds ``init`` until the row's own last valid step
    and starts there. The output of a step is the carry's first element
    (or the carry), frozen rows included. Returns ``(final carry,
    outputs [T, B, ...])`` with the outputs in time order."""
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    carry, outs = init, []
    for t in steps:
        new = cell_step(carry, xs[t])
        if lengths is not None:
            keep = (t < lengths)[:, None]
            new = tree_map(lambda n, o: torch.where(keep, n, o), new, carry)
        carry = new
        outs.append(new[0] if isinstance(new, tuple) else new)
    if reverse:
        outs.reverse()
    return carry, torch.stack(outs)


@register_op("lstm")
def lstm(x, h0, c0, w_ih, w_hh, b=None, lengths=None, reverse=False,
         time_major=False):
    """Multi-step LSTM (ref: ``ops/rnn.py:87``). x ``[B, T, I]`` (``[T,
    B, I]`` when time_major). Returns ``(out [B, T, H], (h, c))``."""
    if not time_major:
        x = x.transpose(0, 1)

    def step(carry, x_t):
        return lstm_cell(x_t, carry[0], carry[1], w_ih, w_hh, b)

    (h, c), outs = _masked_scan(step, x, (h0, c0), lengths, reverse)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, (h, c)


@register_op("gru")
def gru(x, h0, w_ih, w_hh, b_ih=None, b_hh=None, lengths=None,
        reverse=False, time_major=False):
    """Multi-step GRU (ref: ``ops/rnn.py:107``). Returns ``(out [B, T,
    H], h)``."""
    if not time_major:
        x = x.transpose(0, 1)

    def step(h, x_t):
        return gru_cell(x_t, h, w_ih, w_hh, b_ih, b_hh)

    h, outs = _masked_scan(step, x, h0, lengths, reverse)
    if not time_major:
        outs = outs.transpose(0, 1)
    return outs, h


@register_op("bidirectional_lstm")
def bidirectional_lstm(x, h0, c0, params_fwd, params_bwd, lengths=None):
    """Forward and backward LSTM outputs concatenated (ref:
    ``ops/rnn.py:123``); params_* are ``(w_ih, w_hh, b)``. Returns
    ``(out [B, T, 2H], ((hf, hb), (cf, cb)))``."""
    out_f, (hf, cf) = lstm(x, h0, c0, *params_fwd, lengths=lengths)
    out_b, (hb, cb) = lstm(x, h0, c0, *params_bwd, lengths=lengths,
                           reverse=True)
    return torch.cat([out_f, out_b], -1), ((hf, hb), (cf, cb))


@register_op("beam_search")
def beam_search_step(pre_scores, log_probs, beam_size, eos_id=None,
                     done=None):
    """One beam-search selection step (ref: ``ops/rnn.py:173``).
    pre_scores ``[B, K]`` cumulative log-probs; log_probs ``[B, K, V]``.
    With ``done`` ``[B, K]``, a finished beam may only extend with
    ``eos_id`` at zero cost (so it carries its score). Returns
    ``(tokens [B, K] int32, scores [B, K], parents [B, K] int32)``;
    parents index the source beam."""
    b, k, v = log_probs.shape
    if done is not None:
        enforce(eos_id is not None,
                "beam_search: done beams need eos_id to carry their "
                "finished hypothesis (the reference's end_id)")
        keep_eos = torch.full((v,), NEG_INF, dtype=torch.float32,
                              device=log_probs.device)
        keep_eos[eos_id] = 0.0
        log_probs = torch.where(done[:, :, None], keep_eos[None, None],
                                log_probs)
    cand = (pre_scores[:, :, None] + log_probs).reshape(b, k * v)
    scores, idx = top_k(cand, beam_size)
    return ((idx % v).to(torch.int32), scores,
            torch.div(idx, v, rounding_mode="floor").to(torch.int32))


@register_op("beam_search_decode")
def beam_search_decode(log_probs_fn, init_state, bos_id, eos_id, beam_size,
                       max_len, batch_size, vocab_size):
    """Static-shape beam search (ref: ``ops/rnn.py:132``).
    ``log_probs_fn(tokens [B*K], state) -> (log_probs [B*K, V], state)``;
    the state is a tree of ``[B*K, ...]`` tensors, gathered along the
    parents each step. Runs all ``max_len`` steps (finished beams extend
    with eos at zero cost). Returns ``(sequences [B, K, max_len] int32,
    scores [B, K])``."""
    k = beam_size
    dev = tree_leaves(init_state)[0].device
    tokens = torch.full((batch_size * k,), bos_id, dtype=torch.int32,
                        device=dev)
    # only beam 0 is live at t=0, so the k copies do not fill the beam
    first = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
    first[0] = 0.0
    scores = first.repeat(batch_size)
    seqs = torch.full((batch_size, k, max_len), eos_id, dtype=torch.int32,
                      device=dev)
    done = torch.zeros(batch_size * k, dtype=torch.bool, device=dev)
    state = init_state
    rows = torch.arange(batch_size, device=dev)[:, None] * k
    for t in range(max_len):
        logp, state = log_probs_fn(tokens, state)
        tok, top, parent = beam_search_step(
            scores.reshape(batch_size, k),
            logp.reshape(batch_size, k, vocab_size), k, eos_id=eos_id,
            done=done.reshape(batch_size, k))
        flat = (rows + parent.long()).reshape(-1)
        seqs = seqs.reshape(batch_size * k, max_len)[flat].reshape(
            batch_size, k, max_len)
        seqs[:, :, t] = tok
        tokens = tok.reshape(-1)
        done = done[flat] | (tokens == eos_id)
        state = tree_map(lambda s: s[flat], state)
        scores = top.reshape(-1)
    return seqs, scores.reshape(batch_size, k)
