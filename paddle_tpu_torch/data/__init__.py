"""Data readers of the port (``paddle_tpu/data``): the DataLoader with
device prefetch, batching, the in-memory dataset and the synthetic CTR
stream."""
from paddle_tpu_torch.data.dataset import (InMemoryDataset,  # noqa: F401
                                           synthetic_ctr)
from paddle_tpu_torch.data.loader import DataLoader, batch  # noqa: F401
