"""Data readers of the port (``paddle_tpu/data``): what the Trainer
uses."""
from paddle_tpu_torch.data.loader import batch  # noqa: F401
