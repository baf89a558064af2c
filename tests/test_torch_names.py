"""The port's test files define each test once: a second module-level (or
class-level) ``def test_x`` of the same name replaces the first, and
pytest then never collects the first."""

import ast
import glob
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _twice(tree):
    """``[(scope, name)]`` of the ``test_*`` functions defined more than
    once at module level or in one class body."""
    out = []
    scopes = [("module", tree.body)] + [
        (node.name, node.body) for node in tree.body
        if isinstance(node, ast.ClassDef)]
    for scope, body in scopes:
        seen = set()
        for node in body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name.startswith("test")):
                if node.name in seen:
                    out.append((scope, node.name))
                seen.add(node.name)
    return out


def test_no_test_name_is_defined_twice_in_a_file():
    files = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    assert len(files) > 10
    twice = {}
    for path in files:
        with open(path) as f:
            found = _twice(ast.parse(f.read(), path))
        if found:
            twice[os.path.basename(path)] = found
    assert not twice, twice


def test_the_check_finds_a_shadowed_test():
    tree = ast.parse("def test_a(): pass\n"
                     "def test_b(): pass\n"
                     "class TestC:\n"
                     "    def test_d(self): pass\n"
                     "    def test_d(self): pass\n"
                     "def test_a(): pass\n")
    assert _twice(tree) == [("module", "test_a"), ("TestC", "test_d")]


#: the modules this slice ported, and the reference's public names each
#: must carry (the reference's ``__all__`` where it has one)
PUBLIC = {
    "data.formats": None,
    "data.native": ("available", "write_record_file", "NativeRecordReader",
                    "numpy_records", "unpack_numpy_record"),
    "data": ("FileDataset", "InMemoryDataset", "synthetic_ctr",
             "synthetic_images", "synthetic_mnist", "synthetic_tokens",
             "build_dict", "cifar_reader", "corpus_reader", "mnist_reader",
             "ngram_reader", "read_idx", "tokenize_text", "py_reader",
             "double_buffer", "DataLoader", "batch", "shuffle"),
    "initializer": ("constant", "zeros", "ones", "uniform", "normal",
                    "truncated_normal", "xavier", "msra", "bilinear",
                    "numpy_array"),
    "distributions": ("Distribution", "Uniform", "Normal", "Categorical",
                      "MultivariateNormalDiag"),
    "ops.graph": ("tree_patch_coefficients", "tree_conv", "tree_conv_layer"),
    "ops.fused": ("fused_xent_enabled",),
    "models.word2vec": ("Word2Vec", "SkipGramNCE", "lm_loss"),
    "nn": ("FC", "NCE", "BatchNorm", "BilinearTensorProduct", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Dropout", "Embedding", "GRU",
           "GroupNorm", "GRUUnit", "LSTM", "LayerNorm", "Linear",
           "MultiHeadAttention", "Pool2D", "PRelu", "RMSNorm", "RowConv",
           "SequenceConv", "SpectralNorm", "TreeConv", "fused_ffn",
           "tied_vocab_head"),
}


def test_the_ported_modules_carry_the_references_public_names():
    import importlib
    missing = {}
    for mod, names in PUBLIC.items():
        ref = importlib.import_module(f"paddle_tpu.{mod}")
        port = importlib.import_module(f"paddle_tpu_torch.{mod}")
        want = names if names is not None else ref.__all__
        assert all(hasattr(ref, n) for n in want), mod
        lost = [n for n in want if not hasattr(port, n)]
        if lost:
            missing[mod] = lost
    assert not missing, missing
    from paddle_tpu_torch.data import formats
    assert formats.__all__ == importlib.import_module(
        "paddle_tpu.data.formats").__all__
