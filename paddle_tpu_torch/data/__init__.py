"""Data readers of the port (``paddle_tpu/data``): the DataLoader with
device prefetch, batching and shuffling, the in-memory and file-backed
datasets over the native record reader (``native.py``), the synthetic
streams, and the offline format parsers (``formats.py``)."""
from paddle_tpu_torch.data import formats, native  # noqa: F401
from paddle_tpu_torch.data.dataset import (FileDataset,  # noqa: F401
                                           InMemoryDataset, synthetic_ctr,
                                           synthetic_images,
                                           synthetic_mnist,
                                           synthetic_tokens)
from paddle_tpu_torch.data.formats import (build_dict,  # noqa: F401
                                           cifar_reader, corpus_reader,
                                           mnist_reader, ngram_reader,
                                           read_idx, tokenize_text)
from paddle_tpu_torch.data.loader import (DataLoader, batch,  # noqa: F401
                                          shuffle)


def py_reader(feed_list=None, capacity=8, **kw):
    """ref: ``paddle_tpu/data/__init__.py:24`` — the reference's
    graph-variable reader has no counterpart; it raises, pointing at
    ``DataLoader.from_generator``, as the reference does."""
    raise NotImplementedError(
        "py_reader's graph-variable contract does not exist here; use "
        "paddle_tpu_torch.data.DataLoader.from_generator(generator, "
        "batch_size) — it covers py_reader + double_buffer (background "
        "device prefetch)")


def double_buffer(reader, **kw):
    """ref: ``paddle_tpu/data/__init__.py:34`` — the DataLoader already
    stages batch t+1 while t computes, so this is the identity."""
    return reader
