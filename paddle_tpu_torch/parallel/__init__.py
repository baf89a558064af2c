"""The sparse-row tier of ``paddle_tpu/parallel``: the tables of
``parallel/sparse.py``. No collective is ported."""
from paddle_tpu_torch.parallel.sparse import (  # noqa: F401
    FeatureTable, HostTable, ShardedHostTable, SparseTable, segment_rowsum,
    unique_ids)
