"""Per-request masked sampling for the serving engine (ref: the ``_sample``
closure of ``paddle_tpu/serving/engine.py:394``).

The mask is the reference's: logits scaled by ``1 / max(temperature,
1e-6)``, a descending sort, the k-th value (``top_k``, 0 = off) and the
nucleus threshold (``top_p``, off outside ``(0, 1)``) from an f32
``cumsum(softmax)`` that keeps at least one row; an entry is kept when
``scaled >= kth and scaled >= pth``, so every entry tied at a threshold
is kept. Masked entries get ``-1e30``. Rows with ``temperature == 0``
return ``argmax`` of the raw logits (first index on ties), bitwise the
greedy path's token.

The draw is Gumbel-max over the kept entries. Its uniforms come from a
counter-based Philox-4x32-10 written in torch integer ops: key
``(base_seed, request seed)``, counter ``(token index, vocab index, 0,
0)``, 32-bit words held in int64 and wrapped with ``& 0xFFFFFFFF``. So
the draw for token ``i`` of a request depends only on ``(base_seed,
seed, i)``, never on the slot, the batch or the other requests, and the
CPU and the card draw bit-identical uniforms without a host sync. The
tokens cannot equal the reference's (it draws from threefry); the mask
and the distribution are what agree.
"""

import torch

MASKED = -1e30
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of ``a * b`` for 32-bit int64 tensors: split
    ``b`` in 16-bit halves so no product leaves int64."""
    p0 = a * (b & 0xFFFF)                      # < 2^48
    p1 = a * (b >> 16)                         # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)           # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(counter, key, rounds=10):
    """Philox-4x32 (Salmon et al., SC 2011) on int64 tensors holding
    32-bit words. ``counter``: 4 broadcastable tensors; ``key``: 2.
    Returns the 4 output words. The two multiplied words (0 and 2) and
    the two passed-through words (1 and 3) each travel stacked on a
    leading axis of 2, so a round is one multiply-high/low, one xor and
    two swaps whatever the shape: half the launches of word-by-word
    arithmetic, for the same bits."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    dev = c0.device
    x = torch.stack([c0, c2])                  # the multiplied words
    y = torch.stack([c1, c3])
    lead = (2,) + (1,) * c0.dim()
    # the per-lane constants, made on the device (no host-to-device copy,
    # which would wait for the work queued before it)
    lane = torch.arange(2, dtype=torch.int64, device=dev).view(lead)
    m = _PHILOX_M[0] + lane * (_PHILOX_M[1] - _PHILOX_M[0])
    w = _PHILOX_W[0] + lane * (_PHILOX_W[1] - _PHILOX_W[0])
    k = torch.stack(torch.broadcast_tensors(*key))
    k = k.view(lead[:1] + k.shape[1:])
    steps = torch.arange(rounds, dtype=torch.int64, device=dev)
    keys = (k + steps.view((rounds,) + (1,) * k.dim()) * w) & _MASK32
    for r in range(rounds):
        hi, lo = _mulhilo(m, x)
        # word 0 <- hi(word 2) ^ word 1 ^ k0, word 2 <- hi(word 0) ^
        # word 3 ^ k1; words 1, 3 <- lo(word 2), lo(word 0)
        x, y = hi.flip(0) ^ y ^ keys[r], lo.flip(0)
    return x[0], y[0], x[1], y[1]


def uniforms(base_seed, seeds, counts, vocab):
    """``[B, vocab]`` f32 uniforms in ``[2^-24, 1 - 2^-24]`` (never 0 or
    1): row ``b``, column ``v`` is Philox word 0 of counter ``(counts[b],
    v, 0, 0)`` under key ``(base_seed, seeds[b])``, its top 23 bits
    centred in their bin. Exact in f32, so equal on every device."""
    dev = seeds.device
    col = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k0 = torch.full_like(seeds, int(base_seed) & _MASK32,
                         dtype=torch.int64)
    word, _, _, _ = philox4x32(
        ((counts.long() & _MASK32)[:, None], col, zero, zero),
        (k0[:, None], (seeds.long() & _MASK32)[:, None]))
    return ((word >> 9).float() + 0.5) * 2.0 ** -23


def sampling_mask(logits, temps, top_ks, top_ps):
    """The reference's kept set: ``(scaled, keep)`` for logits ``[B, V]``
    and the per-row knobs ``[B]``."""
    v = logits.shape[-1]
    scaled = logits.float() / torch.clamp(temps.float(), min=1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, torch.clamp(top_ks.long(), max=v),
                        torch.full_like(top_ks, v, dtype=torch.int64))
    kth = torch.gather(desc, 1, (k_eff - 1)[:, None])
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    top_ps = top_ps.float()
    p_eff = torch.where((top_ps > 0.0) & (top_ps < 1.0), top_ps,
                        torch.ones_like(top_ps))
    # the smallest set of top rows whose mass reaches p (at least one)
    n_keep = torch.clamp(((cum - probs) < p_eff[:, None]).sum(-1), min=1)
    pth = torch.gather(desc, 1, (n_keep - 1)[:, None])
    return scaled, (scaled >= kth) & (scaled >= pth)


def sample(logits, temps, top_ks, top_ps, seeds, counts, base_seed):
    """Per-row tokens ``[B]`` int64 for logits ``[B, V]``: ``argmax`` where
    ``temps == 0``, else a Gumbel-max draw over the masked, scaled logits
    with the uniforms of :func:`uniforms`. The knobs are ``[B]`` tensors
    on the logits' device."""
    greedy = torch.argmax(logits, dim=-1)
    scaled, keep = sampling_mask(logits, temps, top_ks, top_ps)
    masked = torch.where(keep, scaled, torch.full_like(scaled, MASKED))
    u = uniforms(base_seed, seeds, counts, logits.shape[-1])
    drawn = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temps > 0, drawn, greedy)
