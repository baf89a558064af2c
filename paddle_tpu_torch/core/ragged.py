"""Ragged (variable-length) batches, the LoDTensor's counterpart (ref:
``paddle_tpu/core/ragged.py``).

A :class:`RaggedBatch` is the sequences concatenated along dim 0
(``values [total, ...]``) with their int32 ``row_lengths``; ops turn it
into a dense padded batch and mask (:meth:`RaggedBatch.to_padded`) or
into segment ids for the segment reductions (:meth:`~RaggedBatch.
segment_ids`). :class:`NestedRagged` carries several LoD levels, outermost
first. The reference registers both as pytrees; here they are plain
dataclasses of tensors. Host constructors (``from_list``, ``from_parts``,
``from_nested_list``) take ``device=`` (the card by default; they raise
without one unless asked for the CPU), and, as ``jnp.asarray`` does in
the reference, store 64-bit numpy inputs as int32 or float32.
"""

import dataclasses

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.enforce import enforce

#: numpy's 64-bit types as jnp.asarray stores them (x64 off)
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32,
           np.dtype(np.uint64): np.uint32}


def as_tensor(x, dtype=None, device="cuda"):
    """``x`` (a tensor, array or nested list) as a tensor on ``device``;
    numpy inputs are read as ``np.asarray(x, dtype)`` and narrowed from
    64 bits as ``jnp.asarray`` narrows them."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    arr = np.asarray(x, dtype=dtype)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def repeat_ids(ids, lengths, total):
    """``ids[i]`` repeated ``lengths[i]`` times, ``total`` entries in all
    (``jnp.repeat(ids, lengths, total_repeat_length=total)``; here
    ``total`` must be the lengths' sum, as every ragged layout keeps it).
    Giving the size spares the card a host read."""
    return torch.repeat_interleave(ids, lengths.long(), output_size=total)


@dataclasses.dataclass
class RaggedBatch:
    """Concatenated sequences and their lengths (LoD level 1): ``values
    [total_len, ...]``, ``row_lengths [batch]`` int32 (summing to
    ``total_len``)."""

    values: torch.Tensor
    row_lengths: torch.Tensor

    @property
    def nrows(self):
        return self.row_lengths.shape[0]

    def offsets(self):
        """LoD offsets ``[batch + 1]`` int32."""
        zero = torch.zeros(1, dtype=torch.int32,
                           device=self.row_lengths.device)
        return torch.cat([zero, torch.cumsum(self.row_lengths, 0)]).to(
            torch.int32)

    def segment_ids(self):
        """``[total_len]`` int32: the row of each element."""
        rows = torch.arange(self.nrows, dtype=torch.int32,
                            device=self.row_lengths.device)
        return repeat_ids(rows, self.row_lengths, self.values.shape[0])

    def to_padded(self, max_len=None, pad_value=0):
        """``(dense [batch, max_len, ...], valid [batch, max_len] bool)``;
        ``max_len`` defaults to ``total_len``. Past a row's end the dense
        batch holds ``pad_value``."""
        max_len = (int(max_len) if max_len is not None
                   else int(self.values.shape[0]))
        dev = self.values.device
        offs = self.offsets()[:-1].long()
        pos = torch.arange(max_len, device=dev)
        idx = (offs[:, None] + pos[None, :]).clamp(
            0, self.values.shape[0] - 1)
        valid = pos[None, :] < self.row_lengths[:, None]
        dense = self.values[idx]
        shape = valid.shape + (1,) * (dense.ndim - 2)
        if pad_value != 0:
            dense = torch.where(valid.reshape(shape), dense, pad_value)
        else:
            dense = dense * valid.reshape(shape).to(dense.dtype)
        return dense, valid

    @staticmethod
    def from_list(seqs, dtype=None, device="cuda"):
        """From a list of arrays or lists (host)."""
        arrs = [np.asarray(s, dtype=dtype) for s in seqs]
        enforce(len(arrs) > 0, "empty ragged batch")
        values = np.concatenate(arrs, axis=0)
        lengths = np.array([a.shape[0] for a in arrs], np.int32)
        return RaggedBatch(as_tensor(values, device=device),
                           as_tensor(lengths, device=device))

    @staticmethod
    def from_padded(dense, lengths):
        """Inverse of :meth:`to_padded`: the valid entries in row order,
        gathered by a stable sort of the padding flags. Reads the total
        length on the host, as the reference does."""
        b, m = dense.shape[:2]
        lengths = torch.as_tensor(lengths, device=dense.device).to(
            torch.int32)
        valid = (torch.arange(m, device=dense.device)[None, :]
                 < lengths[:, None])
        flat = dense.reshape((b * m,) + tuple(dense.shape[2:]))
        order = torch.argsort((~valid).reshape(-1).to(torch.uint8),
                              stable=True)
        total = int(lengths.sum())
        return RaggedBatch(flat[order][:total], lengths)


def bucket_boundaries(max_len, num_buckets=8):
    """Geometric length buckets up to ``max_len`` (ref:
    ``core/ragged.py:109``)."""
    bounds = []
    b = max(8, max_len // (2 ** (num_buckets - 1)))
    while b < max_len:
        bounds.append(b)
        b *= 2
    bounds.append(max_len)
    return bounds


def bucket_for(length, boundaries):
    for b in boundaries:
        if length <= b:
            return b
    return boundaries[-1]


@dataclasses.dataclass
class NestedRagged:
    """Several LoD levels (ref: ``core/ragged.py:130``): ``values
    [total_innermost, ...]`` and ``lengths``, a tuple of int32 vectors,
    outermost first; ``lengths[-1]`` measures rows of ``values`` and
    ``lengths[k]`` entries of ``lengths[k + 1]``. Two documents of 2 and
    1 sentences of 3, 1 and 2 words: ``lengths = ([2, 1], [3, 1, 2])``."""

    values: torch.Tensor
    lengths: tuple

    @property
    def num_levels(self):
        return len(self.lengths)

    def check(self):
        """Each level's lengths sum to the next level's row count (host
        reads)."""
        for k in range(self.num_levels - 1):
            enforce(int(self.lengths[k].sum())
                    == int(self.lengths[k + 1].shape[0]),
                    "level %d lengths must sum to level %d row count",
                    k, k + 1)
        enforce(int(self.lengths[-1].sum()) == int(self.values.shape[0]),
                "innermost lengths must sum to the value count")
        return self

    def level(self, k):
        """Level ``k`` as a :class:`RaggedBatch`: the values for the
        innermost level, the next level's lengths for an outer one."""
        if k == self.num_levels - 1:
            return RaggedBatch(self.values, self.lengths[k])
        return RaggedBatch(self.lengths[k + 1], self.lengths[k])

    def flatten_outer(self):
        """Drop the outermost level."""
        enforce(self.num_levels >= 2, "need >= 2 levels to flatten")
        return NestedRagged(self.values, tuple(self.lengths[1:]))

    def outer_segment_ids(self):
        """``[total_innermost]`` int32: the outermost group of each
        value, one repeat down each level."""
        ids = torch.arange(self.lengths[0].shape[0], dtype=torch.int32,
                           device=self.lengths[0].device)
        for k in range(self.num_levels):
            total = (int(self.lengths[k + 1].shape[0])
                     if k + 1 < self.num_levels
                     else int(self.values.shape[0]))
            ids = repeat_ids(ids, self.lengths[k], total)
        return ids

    @staticmethod
    def from_parts(values, lengths, device="cuda"):
        """From values ``[total, ...]`` and per-level lengths (outermost
        first)."""
        return NestedRagged(
            as_tensor(values, device=device),
            tuple(as_tensor(v, device=device).to(torch.int32)
                  for v in lengths)).check()

    @staticmethod
    def from_nested_list(nested, dtype=None, device="cuda"):
        """From nested lists of scalars, outermost first (documents ->
        sentences -> word ids)."""
        lengths_per_level = []
        layer = list(nested)
        while layer and isinstance(layer[0], (list, tuple, np.ndarray)):
            lengths_per_level.append(
                np.asarray([len(x) for x in layer], np.int32))
            layer = [y for x in layer for y in x]
        enforce(lengths_per_level, "from_nested_list needs nested lists")
        return NestedRagged(
            as_tensor(np.asarray(layer, dtype=dtype), device=device),
            tuple(as_tensor(v, device=device)
                  for v in lengths_per_level)).check()
