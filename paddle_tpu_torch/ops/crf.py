"""Linear-chain CRF and edit distance (ref: ``paddle_tpu/ops/crf.py``).

Sequences are padded ``[B, T, K]`` with lengths; each ``lax.scan`` of the
reference is a Python loop over time steps here, as ``ops/rnn.py`` loops
its recurrences, and the gradient of :func:`linear_chain_crf` comes from
autograd. The transition keeps the reference's layout ``[K + 2, K]``:
row 0 the start weights, row 1 the stop weights, rows 2: the score of
tag i -> tag j. The reference writes no Pallas kernel for any of this,
so neither does the port.
"""

import torch

from paddle_tpu_torch.core.registry import register_op


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


def _valid(lengths, T, device):
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None])


@register_op("linear_chain_crf")
def linear_chain_crf(emission, transition, label, lengths):
    """Negative log-likelihood ``[B]`` of the ``label`` paths (ref:
    ``crf.py:27``): emission ``[B, T, K]``, transition ``[K + 2, K]``,
    label ``[B, T]`` int, lengths ``[B]`` (each >= 1). Past a row's
    length the forward algorithm's state is frozen (a select), so padded
    positions take no gradient."""
    start, stop, trans = _split_transition(transition)
    B, T, K = emission.shape
    mask = _valid(lengths, T, emission.device).to(emission.dtype)

    lab = label.long().clamp(0, K - 1)
    em_score = (emission.gather(-1, lab[..., None])[..., 0] * mask).sum(1)
    pair_scores = trans[lab[:, :-1], lab[:, 1:]]
    tr_score = (pair_scores * mask[:, 1:]).sum(1)
    last_pos = (lengths.to(emission.device).long() - 1).clamp(min=0)
    last_tag = lab.gather(1, last_pos[:, None])[:, 0]
    score = em_score + tr_score + start[lab[:, 0]] + stop[last_tag]

    alpha = start[None, :] + emission[:, 0, :]
    for t in range(1, T):
        nxt = (torch.logsumexp(alpha[:, :, None] + trans[None], dim=1)
               + emission[:, t, :])
        alpha = torch.where(mask[:, t, None] > 0, nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    return log_z - score


@register_op("crf_decoding")
def crf_decoding(emission, transition, lengths, label=None):
    """Viterbi decode (ref: ``crf.py:72``): the best tag path ``[B, T]``
    int32, 0 past each row's length; with ``label``, instead 1 where the
    path equals the label and 0 elsewhere. Ties go to the lowest tag, as
    ``jnp.argmax`` breaks them (``torch.argmax`` returns the first maximal
    index too); past a row's end each backpointer points at its own tag,
    so the backtrace carries the last tag through the padding."""
    start, stop, trans = _split_transition(transition)
    B, T, K = emission.shape
    mask = _valid(lengths, T, emission.device)
    own = torch.arange(K, device=emission.device)[None, :]

    alpha = start[None, :] + emission[:, 0, :]
    backptrs = []
    for t in range(1, T):
        cand = alpha[:, :, None] + trans[None]                 # [B, K, K]
        m_t = mask[:, t, None]
        alpha = torch.where(m_t, cand.amax(1) + emission[:, t, :], alpha)
        backptrs.append(torch.where(m_t, cand.argmax(1), own))
    tag = (alpha + stop[None, :]).argmax(1)
    tags = [tag]
    for bp in reversed(backptrs):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.stack(tags[::-1], 1).to(torch.int32)
    path = torch.where(mask, path, 0)
    if label is not None:
        return torch.where(mask, (path == label.to(path.device)).to(
            torch.int32), 0)
    return path


@register_op("edit_distance")
def edit_distance(hyp, hyp_lengths, ref, ref_lengths, normalized=False):
    """Batched Levenshtein distance ``[B]`` f32 (ref: ``crf.py:118``):
    hyp ``[B, T1]``, ref ``[B, T2]`` int with their valid lengths;
    ``normalized`` divides by the reference length (at least 1). One DP
    row a hypothesis token; the insertion chain of a row is resolved with
    a running minimum (``lax.cummin``: ``torch.cummin``)."""
    B, T1 = hyp.shape
    T2 = ref.shape[1]
    dev = hyp.device
    jr = torch.arange(T2 + 1, dtype=torch.float32, device=dev)
    row = jr.expand(B, T2 + 1)
    hyp_lengths = hyp_lengths.to(dev)
    for i in range(T1):
        sub_cost = (ref != hyp[:, i, None]).to(torch.float32)
        c = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub_cost)
        c = torch.cat([row[:, :1] + 1.0, c], 1)
        new = torch.minimum(c, torch.cummin(c - jr, 1).values + jr)
        row = torch.where((i < hyp_lengths)[:, None], new, row)
    ref_lengths = ref_lengths.to(dev)
    res = row.gather(1, ref_lengths.long()[:, None])[:, 0]
    if normalized:
        res = res / torch.clamp(ref_lengths.to(torch.float32), min=1.0)
    return res
