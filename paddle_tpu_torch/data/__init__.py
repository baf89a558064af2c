"""Data readers of the port (``paddle_tpu/data``): what the Trainer
uses, the in-memory dataset and the synthetic CTR stream."""
from paddle_tpu_torch.data.dataset import (InMemoryDataset,  # noqa: F401
                                           synthetic_ctr)
from paddle_tpu_torch.data.loader import batch  # noqa: F401
