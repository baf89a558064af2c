"""Composable RNN cells and the decoding protocol (ref:
``paddle_tpu/nn/rnn.py``).

The ``RNNCell`` protocol (``forward(inputs, states) -> (outputs,
new_states)`` plus ``state_shape``), the stock ``GRUCell`` and
``LSTMCell``, the ``RNN`` driver over a time axis, the ``Decoder``
protocol (initialize / step / finalize), ``BeamSearchDecoder`` over any
cell and ``dynamic_decode``. Any cell that keeps the protocol drives
``RNN``, ``BeamSearchDecoder`` and ``dynamic_decode``; a state is a
tensor or a tuple/list/dict tree of tensors with the batch first.

The reference drives its cells inside ``Module.apply`` and takes
``cell_variables`` for a cell used on its own; a port cell carries its
parameters, so the decoder calls it directly and has no such argument.
"""

import torch
from torch import nn

from paddle_tpu_torch.nn.layers import _xavier
from paddle_tpu_torch.ops.rnn import (NEG_INF, beam_search_step, gru_cell,
                                      lstm_cell, tree_leaves, tree_map)


def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


class RNNCell(nn.Module):
    """Cell protocol (ref: ``nn/rnn.py:30``): implement ``forward(inputs,
    states) -> (outputs, new_states)`` and ``state_shape``, a tree of
    per-example state shapes (the batch excluded)."""

    @property
    def state_shape(self):
        raise NotImplementedError(
            f"{type(self).__name__} must define state_shape")

    def get_initial_states(self, batch_size, dtype=torch.float32,
                           device=None):
        """Zero states ``[batch, *shape]`` on ``device`` (the cell's own
        by default). A shape leaf is a tuple of ints: LSTM's ``((H,),
        (H,))`` is a pair of leaves, GRU's ``(H,)`` one."""
        if device is None:
            device = next(self.parameters()).device

        def zeros(shape):
            return torch.zeros((batch_size,) + tuple(shape), dtype=dtype,
                               device=device)

        def build(spec):
            if _is_shape(spec):
                return zeros(spec)
            if isinstance(spec, dict):
                return {k: build(v) for k, v in spec.items()}
            return type(spec)(build(s) for s in spec)

        return build(self.state_shape)


class GRUCell(RNNCell):
    """ref: ``nn/rnn.py:54`` (origin_mode False, the gru op's default)."""

    def __init__(self, input_size, hidden_size, gen=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_ih = _xavier((input_size, 3 * hidden_size), gen, dtype)
        self.w_hh = _xavier((hidden_size, 3 * hidden_size), gen, dtype)
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden_size, dtype=dtype))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden_size, dtype=dtype))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states):
        h = gru_cell(inputs, states, self.w_ih, self.w_hh, self.b_ih,
                     self.b_hh)
        return h, h


class LSTMCell(RNNCell):
    """ref: ``nn/rnn.py:75``; the states are ``(h, c)``."""

    def __init__(self, input_size, hidden_size, forget_bias=0.0, gen=None,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.w_ih = _xavier((input_size, 4 * hidden_size), gen, dtype)
        self.w_hh = _xavier((hidden_size, 4 * hidden_size), gen, dtype)
        self.b = nn.Parameter(torch.zeros(4 * hidden_size, dtype=dtype))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states):
        h, c = lstm_cell(inputs, states[0], states[1], self.w_ih, self.w_hh,
                         self.b, forget_bias=self.forget_bias)
        return h, (h, c)


class RNN(nn.Module):
    """Drive any cell over a time axis (ref: ``nn/rnn.py:98``). x ``[B,
    T, D]`` -> ``(outputs [B, T, ...], final states)``. With ``lengths``
    a row's state freezes past its length and its outputs there are 0;
    ``is_reverse`` runs from the last step to the first."""

    def __init__(self, cell, is_reverse=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse

    def forward(self, x, initial_states=None, lengths=None):
        b, t = x.shape[0], x.shape[1]
        states = (initial_states if initial_states is not None
                  else self.cell.get_initial_states(b, x.dtype, x.device))
        outs = []
        for i in (range(t - 1, -1, -1) if self.is_reverse else range(t)):
            out, new = self.cell(x[:, i], states)
            if lengths is not None:
                valid = i < lengths
                new = tree_map(lambda n, o: torch.where(
                    valid.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
                    new, states)
                out = out * valid.reshape(
                    (-1,) + (1,) * (out.ndim - 1)).to(out.dtype)
            states = new
            outs.append(out)
        if self.is_reverse:
            outs.reverse()
        return torch.stack(outs, 1), states


class Decoder:
    """Decoding protocol (ref: ``nn/rnn.py:138``): ``initialize(inits) ->
    (inputs, states, finished)``; ``step(time, inputs, states, finished)
    -> (outputs, states, next_inputs, finished)``; ``finalize(outputs,
    final_states)``. Drive it with :func:`dynamic_decode`."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, finished):
        raise NotImplementedError

    def finalize(self, outputs, final_states):
        """Post-process the stacked per-step outputs (identity)."""
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam search over any cell (ref: ``nn/rnn.py:154``). cell: an
    :class:`RNNCell`; ``embedding_fn(tokens [N]) -> [N, D]`` step inputs;
    ``output_fn(cell_out [N, H]) -> [N, V]`` logits. Every state tensor is
    tiled to batch x beam rows; selection is :func:`beam_search_step`."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn, output_fn, vocab_size):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.vocab_size = vocab_size

    def tile_beam(self, x):
        """``[B, ...] -> [B*K, ...]``, each row repeated K times."""
        return torch.repeat_interleave(x, self.beam_size, dim=0)

    def initialize(self, initial_states):
        """``initial_states``: per-example cell states ``[B, ...]`` (the
        encoder's final state), tiled to the beams here."""
        first = tree_leaves(initial_states)[0]
        b, k, dev = first.shape[0], self.beam_size, first.device
        states = tree_map(self.tile_beam, initial_states)
        tokens = torch.full((b * k,), self.start_token, dtype=torch.int32,
                            device=dev)
        # only beam 0 is live at t=0, so the k copies do not fill the beam
        live = torch.full((k,), NEG_INF, dtype=torch.float32, device=dev)
        live[0] = 0.0
        finished = torch.zeros(b * k, dtype=torch.bool, device=dev)
        return tokens, (states, live.repeat(b)), finished

    def step(self, time, inputs, states_and_scores, finished):
        cell_states, scores = states_and_scores
        k = self.beam_size
        b = inputs.shape[0] // k
        out, new_states = self.cell(self.embedding_fn(inputs), cell_states)
        logp = torch.log_softmax(self.output_fn(out), dim=-1)
        tokens, new_scores, parent = beam_search_step(
            scores.reshape(b, k), logp.reshape(b, k, self.vocab_size), k,
            eos_id=self.end_token, done=finished.reshape(b, k))
        flat = (torch.arange(b, device=inputs.device)[:, None] * k
                + parent.long()).reshape(-1)
        new_states = tree_map(lambda s: s[flat], new_states)
        next_tokens = tokens.reshape(-1)
        finished = finished[flat] | (next_tokens == self.end_token)
        outputs = {"token": tokens, "parent": parent}
        return (outputs, (new_states, new_scores.reshape(-1)), next_tokens,
                finished)

    def finalize(self, outputs, final_states):
        """Backtrace the parent pointers into ``(sequences [B, K, T],
        scores [B, K])`` (ref: ``nn/rnn.py:223``, a reverse walk over the
        stacked parents)."""
        tokens, parents = outputs["token"], outputs["parent"]  # [T, B, K]
        t, b, k = tokens.shape
        beam = torch.arange(k, device=tokens.device).repeat(b, 1)
        seq = []
        for i in range(t - 1, -1, -1):
            seq.append(torch.gather(tokens[i], 1, beam))
            beam = torch.gather(parents[i].long(), 1, beam)
        seqs = torch.stack(seq[::-1], dim=2)
        _, scores = final_states
        return seqs, scores.reshape(b, k)


def dynamic_decode(decoder, initial_states, max_step_num,
                   return_length=False):
    """Run a decoder for ``max_step_num`` steps (ref: ``nn/rnn.py:244``);
    steps after every beam finished still run and change no score.
    Returns ``decoder.finalize``'s pair (for :class:`BeamSearchDecoder`:
    ``(sequences [B, K, T], scores [B, K])``), and the lengths ``[B, K]``
    int32 (up to and including the first end token) with
    ``return_length``."""
    inputs, states, finished = decoder.initialize(initial_states)
    steps = []
    for time in range(max_step_num):
        outputs, states, inputs, finished = decoder.step(time, inputs,
                                                         states, finished)
        steps.append(outputs)
    stacked = tree_map(lambda *xs: torch.stack(xs), *steps)
    seqs, scores = decoder.finalize(stacked, states)
    if return_length:
        eos = (seqs == decoder.end_token).to(torch.int32)
        lengths = torch.where(eos.any(-1), torch.argmax(eos, dim=-1) + 1,
                              torch.full_like(eos[..., 0], seqs.shape[-1]))
        return seqs, scores, lengths.to(torch.int32)
    return seqs, scores
