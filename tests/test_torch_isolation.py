"""The PyTorch port stands alone: paddle_tpu_torch/ and chip_smoke.py import
neither jax nor the JAX package, the port serves and trains on the CPU in
a process where jax, jaxlib, paddle_tpu and triton cannot be imported, and
its entry points refuse to run without a card unless asked for the CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "paddle_tpu", "triton")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, "paddle_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("build",
                                                        "__pycache__")]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return out


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_ast_scan_finds_no_reference_imports():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


_SERVE_BLOCKED = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:          # exact top-level name
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
from paddle_tpu_torch.serving import ServeConfig, ServingEngine
from paddle_tpu_torch.ops.cuda import core
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
eng = ServingEngine(GPTDecoder(cfg, device="cpu"), ServeConfig(
    num_slots=2, page_size=8, max_len=40, prefill_len=16))
rs = np.random.RandomState(0)
for n in (5, 20, 9):
    eng.submit(rs.randint(0, 512, n), max_new=4)
done = eng.drain()
assert len(done) == 3 and all(len(r.tokens) == 4 for r in done)
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("SERVED", sorted(len(r.output) for r in done))
"""


def test_port_serves_with_reference_and_triton_blocked():
    code = _SERVE_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "SERVED [9, 13, 24]" in proc.stdout


_SERVE_FEATURES_BLOCKED = _SERVE_BLOCKED.split("cfg = GPTConfig.tiny()")[0] \
    + r"""
from paddle_tpu_torch.testing import chaos
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
eng = ServingEngine(GPTDecoder(cfg, device="cpu"), ServeConfig(
    num_slots=2, page_size=8, max_len=32, prefill_len=8, num_pages=4))
rs = np.random.RandomState(0)
head = rs.randint(0, 512, 16)
for i, n in enumerate((3, 5, 0, 7)):
    prompt = np.concatenate([head, rs.randint(0, 512, n)])
    eng.submit(prompt, max_new=8, temperature=0.8 * (i % 2), top_k=20,
               top_p=0.9, seed=i)
plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$", nth=9)
with chaos.active(plan):
    done = eng.drain()
assert len(done) == 4 and all(len(r.tokens) == 8 for r in done)
assert eng.prefill_tokens_skipped > 0 and eng.cow_copies > 0
assert eng.preemptions > 0 and eng.recoveries == 1 == plan.fired()
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("SERVED FEATURES", sorted(len(r.output) for r in done))
"""


def test_port_serving_features_run_with_reference_and_triton_blocked():
    """The prefix cache, copy-on-write, sampling, preemption and a
    recovered step fault, in a process that cannot import jax."""
    code = _SERVE_FEATURES_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "SERVED FEATURES [24, 27, 29, 31]" in proc.stdout


_SERVE_SPEC_BLOCKED = _SERVE_BLOCKED.split("cfg = GPTConfig.tiny()")[0] \
    + r"""
import os, tempfile
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability.runlog import read_records
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
draft = GPTConfig.tiny()
draft.dropout = 0.0
draft.num_layers = 1
log = os.path.join(tempfile.mkdtemp(), "serve.jsonl")
for spec in (dict(draft=True, spec_k=3), dict(draft_spec=draft)):
    eng = ServingEngine(GPTDecoder(cfg, device="cpu"), ServeConfig(
        num_slots=2, page_size=8, max_len=40, prefill_len=16, run_log=log,
        slo_ttft_s=1.0, **spec))
    rs = np.random.RandomState(0)
    for n in (5, 20, 9):
        eng.submit(rs.randint(0, 512, n), max_new=6)
    done = eng.drain()
    eng.close()
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done)
    assert eng.spec_stats()["rounds"] > 0 and eng.latency_stats()
assert metrics.counter("serve.spec_proposed").total() > 0
assert sum("event" in r for r in read_records(log)) > 0
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("SERVED SPECULATIVELY", sorted(len(r.output) for r in done))
"""


def test_port_serves_speculatively_with_reference_and_triton_blocked():
    """Speculative serving (self-draft and a separate draft) with metrics
    and a run log, in a process that cannot import jax."""
    code = _SERVE_SPEC_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "SERVED SPECULATIVELY [11, 15, 26]" in proc.stdout


@pytest.mark.parametrize("module", [
    "serving/prefix_cache.py", "serving/sampling.py", "core/retry.py",
    "testing/chaos.py", "serving/engine.py", "observability/metrics.py",
    "observability/runlog.py"])
def test_ast_scan_covers_the_serving_feature_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_TRAIN_BLOCKED = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from paddle_tpu_torch import amp, bridge
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.optimizer import Adam
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
model = GPT(cfg, device="cpu")
opt = amp.decorate(Adam(model.parameters(), 1e-3), amp.bf16_policy())
ids = torch.randint(0, cfg.vocab_size, (2, 16),
                    generator=torch.Generator().manual_seed(0))
losses = [float(opt.minimize(model, lambda m, x: m.loss(x), ids))
          for _ in range(3)]
assert losses[-1] < losses[0], losses
assert int(bridge.export_opt_state(opt, model)["inner"]["step"]) == 3
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("TRAINED", len(losses))
"""


def test_port_trains_with_reference_and_triton_blocked():
    code = _TRAIN_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "TRAINED 3" in proc.stdout


_BERT_BLOCKED = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     ErnieConfig, ErnieForPretraining,
                                     knowledge_mask)
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.optimizer import Adam
rs = np.random.RandomState(0)
for cls, cfg in ((BertForPretraining, BertConfig.tiny()),
                 (ErnieForPretraining, ErnieConfig.tiny())):
    cfg.dropout = 0.0
    model = cls(cfg, device="cpu")
    opt = amp.decorate(Adam(model.parameters(), 1e-3), amp.bf16_policy())
    ids = rs.randint(5, cfg.vocab_size, (2, 32))
    masked, labels, weights = knowledge_mask(ids, [[(2, 6)], [(9, 12)]], 1,
                                             cfg.vocab_size, 0.3, seed=1)
    att = np.ones((2, 32), np.float32)
    att[1, 20:] = 0.0
    args = [torch.from_numpy(a) for a in (masked, labels,
                                          rs.randint(0, 2, 2), weights, att)]
    losses = [float(opt.minimize(model, lambda m, i, l, n, w, a: m.loss(
        i, l, n, w, attention_mask=a), *args)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("PRETRAINED", len(losses))
"""


def test_port_pretrains_bert_and_ernie_with_reference_and_triton_blocked():
    code = _BERT_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "PRETRAINED 3" in proc.stdout


def test_bert_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         ErnieConfig, ErnieForPretraining)
    with pytest.raises(EnforceError):
        BertForPretraining(BertConfig.tiny())
    with pytest.raises(EnforceError):
        ErnieForPretraining(ErnieConfig.tiny())
    assert BertForPretraining(BertConfig.tiny(),
                              device="cpu").device == torch.device("cpu")


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.attention import init_page_pool
    with pytest.raises(EnforceError):
        GPTDecoder(GPTConfig.tiny())
    with pytest.raises(EnforceError):
        init_page_pool(4, 2, 8, 16)
    with pytest.raises(EnforceError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and also when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


@pytest.mark.parametrize("module", [
    "models/transformer.py", "models/seq2seq.py", "ops/rnn.py", "nn/rnn.py",
    "ops/fused.py", "ops/nn.py"])
def test_ast_scan_covers_the_translation_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_TRANSLATE_BLOCKED = _SERVE_BLOCKED.split("from paddle_tpu_torch.models")[0] \
    + r"""
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (AttentionSeq2Seq, Seq2SeqConfig,
                                     Transformer, TransformerConfig)
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.optimizer import Adam
rs = np.random.RandomState(0)
cfg = TransformerConfig.tiny()
cfg.dropout = 0.0
model = Transformer(cfg, device="cpu")
src, tgt_in, tgt_out = (torch.from_numpy(rs.randint(1, 1000, (2, 12)))
                        for _ in range(3))
mask = torch.ones(2, 12)
mask[1, 7:] = 0.0
loss = model.loss(src, tgt_in, tgt_out, mask)
loss.backward()
assert all(p.grad is not None for p in model.parameters())
opt = amp.decorate(Adam(model.parameters(), 1e-3), amp.bf16_policy())
opt.minimize(model, lambda m, *a: m.loss(*a), src, tgt_in, tgt_out, mask)
s2s = AttentionSeq2Seq(Seq2SeqConfig.tiny(), device="cpu")
seqs, scores = s2s.beam_decode(torch.from_numpy(rs.randint(3, 64, (3, 9))),
                               torch.tensor([9, 4, 1]), 1, 2, 4, 8)
assert tuple(seqs.shape) == (3, 4, 8) and bool(torch.isfinite(scores).all())
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("TRANSLATED", tuple(seqs.shape))
"""


def test_port_translates_with_reference_and_triton_blocked():
    """A Transformer loss, its backward and a bf16 Adam step, and a
    seq2seq beam decode, in a process that cannot import jax."""
    code = _TRANSLATE_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "TRANSLATED (3, 4, 8)" in proc.stdout


def test_translation_models_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models import (AttentionSeq2Seq, Seq2SeqConfig,
                                         Transformer, TransformerConfig)
    with pytest.raises(EnforceError):
        Transformer(TransformerConfig.tiny())
    with pytest.raises(EnforceError):
        AttentionSeq2Seq(Seq2SeqConfig.tiny())
    assert Transformer(TransformerConfig.tiny(),
                       device="cpu").device == torch.device("cpu")
    assert AttentionSeq2Seq(Seq2SeqConfig.tiny(),
                            device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("module", [
    "models/resnet.py", "models/vision_cls.py", "models/mnist.py",
    "initializer.py", "nn/layers.py", "amp.py", "bridge.py"])
def test_ast_scan_covers_the_vision_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_VISION_BLOCKED = _SERVE_BLOCKED.split("from paddle_tpu_torch.models")[0] \
    + r"""
from paddle_tpu_torch import amp, bridge
from paddle_tpu_torch.models import ConvNet, VGG, resnet18
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
from paddle_tpu_torch.optimizer import Momentum
rs = np.random.RandomState(0)
images = torch.from_numpy(rs.rand(4, 3, 32, 32).astype(np.float32))
labels = torch.from_numpy(rs.randint(0, 10, (4, 1)))
model = resnet18(10, small_input=True, device="cpu")
before = dict((k, b.clone()) for k, b in model.named_buffers())
opt = amp.decorate(Momentum(model.parameters(), 0.01, 0.9), amp.bf16_policy())
xent = lambda m, x, y: softmax_with_cross_entropy(m(x), y).mean()
losses = [float(opt.minimize(model, xent, images, labels)) for _ in range(3)]
assert losses[-1] < losses[0], losses
assert all(not torch.equal(b, before[k]) for k, b in model.named_buffers())
assert len(bridge.flatten(bridge.export_state(model))) == 40
vgg = VGG(11, 10, device="cpu")
Momentum(vgg.parameters(), 0.01).minimize(vgg, xent, images, labels)
ConvNet(device="cpu").eval()(torch.zeros(2, 1, 28, 28))
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("CLASSIFIED", len(losses))
"""


def test_port_trains_resnet_with_reference_and_triton_blocked():
    """Three bf16-policy Momentum steps of ResNet-18 (running statistics
    moved), a VGG step and a ConvNet forward, in a process that cannot
    import jax."""
    code = _VISION_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "CLASSIFIED 3" in proc.stdout


def test_vision_models_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models import (MLP, VGG, ConvNet, SEResNeXt,
                                         resnet50)
    for make in (resnet50, VGG, lambda: SEResNeXt((1, 1, 1, 1)), ConvNet,
                 MLP):
        with pytest.raises(EnforceError):
            make()
    assert resnet50(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/sparse.py", "models/ctr.py",
    "models/recommender.py", "models/word2vec.py", "metrics.py",
    "data/dataset.py", "static/trainer.py"])
def test_ast_scan_covers_the_ctr_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_CTR_BLOCKED = _SERVE_BLOCKED.split("from paddle_tpu_torch.models")[0] \
    + r"""
from paddle_tpu_torch.data import InMemoryDataset, synthetic_ctr
from paddle_tpu_torch.metrics import Auc
from paddle_tpu_torch.models import (CTRConfig, DeepFM, WideAndDeep,
                                     ctr_loss, make_sparse_deepfm_train_step)
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.optimizer import Adagrad, Adam
from paddle_tpu_torch.parallel import HostTable, SparseTable
from paddle_tpu_torch.static import Trainer, TrainerConfig
cfg = CTRConfig.tiny()
rs = np.random.RandomState(0)
dense = torch.from_numpy(rs.rand(16, 3).astype(np.float32))
sparse = torch.from_numpy(rs.randint(0, 100, (16, 4)).astype(np.int32))
labels = torch.from_numpy(rs.randint(0, 2, (16, 1)).astype(np.float32))
model = DeepFM(cfg, sparse_tables=True, device="cpu")
tbls = [SparseTable(cfg.total_vocab, d, lambda ps: Adagrad(ps, 0.05))
        for d in (cfg.embed_dim, 1)]
states = [tb.init(device="cpu") for tb in tbls]
step = make_sparse_deepfm_train_step(model, Adam(model.parameters(), 1e-2),
                                     *tbls, *states)
losses = [float(step(dense, sparse, labels)) for _ in range(3)]
assert losses[-1] < losses[0], losses
wd = WideAndDeep(cfg, device="cpu")
auc = Auc()
auc.update(torch.sigmoid(wd(dense, sparse)), labels)
host = HostTable(cfg.total_vocab, 1, seed=1)
offsets = np.arange(4) * cfg.vocab_size
head = DeepFM(CTRConfig(4, 3, 100, 1, (8,)), sparse_tables=True,
              device="cpu")
def loss_fn(m, d, s, y, rows, inv):
    first = rows[inv].reshape(d.shape[0], 4, 1)
    return ctr_loss(m.forward_from_emb(d, first, first), y)
Trainer(head, Adam(head.parameters(), 1e-2), loss_fn, TrainerConfig(),
        sparse_tables=[(host, lambda b: b[1] + offsets)],
        device="cpu").train(InMemoryDataset(synthetic_ctr(32, 4, 3, 100)),
                            batch_size=8)
assert host.step == 4
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("CTR TRAINED", len(losses))
"""


def test_port_trains_ctr_with_reference_and_triton_blocked():
    """Three sparse-row DeepFM steps, Wide&Deep into an Auc, and the
    Trainer's Downpour cycle through a HostTable, in a process that
    cannot import jax."""
    code = _CTR_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "CTR TRAINED 3" in proc.stdout


@pytest.mark.parametrize("module", [
    "quant/__init__.py", "quant/ops.py", "quant/weight_only.py",
    "nn/moe.py", "nn/scan.py", "io/checkpoint.py", "models/gpt.py",
    "nn/layers.py", "bridge.py"])
def test_ast_scan_covers_the_gpt_feature_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_GPT_FEATURES_BLOCKED = _SERVE_BLOCKED.split(
    "from paddle_tpu_torch.models")[0] + r"""
from paddle_tpu_torch import amp
from paddle_tpu_torch.io import unstack_layer_tree
from paddle_tpu_torch.bridge import export_params, load_params
from paddle_tpu_torch.models import GPT, GPTConfig, GPTDecoder
from paddle_tpu_torch.ops.cuda import core
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.quant import quantize_weights_int8
from paddle_tpu_torch.serving import ServeConfig, ServingEngine
rs = np.random.RandomState(0)
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
dec = GPTDecoder(cfg, device="cpu")
prompt = torch.from_numpy(rs.randint(0, 512, (2, 6)).astype(np.int32))
out = dec.generate(prompt, 5, cache_dtype=torch.bfloat16)
quantize_weights_int8(dec)
eng = ServingEngine(dec, ServeConfig(num_slots=2, page_size=8, max_len=32,
                                     prefill_len=16))
eng.submit(prompt[0].numpy(), max_new=5)
served = eng.drain()[0].tokens
assert served == dec.generate(prompt[:1], 5)[0, 6:].tolist()
ids = torch.from_numpy(rs.randint(0, 512, (2, 16)).astype(np.int32))
scan = GPTConfig.tiny()
scan.scan_layers, scan.remat, scan.moe_experts = True, "full", 4
model = GPT(scan, device="cpu")
opt = amp.decorate(Adam(model.parameters(), 1e-3), amp.bf16_policy())
loss = opt.minimize(model, lambda m, x: m.loss(x), ids)
assert bool(torch.isfinite(loss))
flat = GPTConfig.tiny()
flat.moe_experts = 4
load_params(GPTDecoder(flat, device="cpu"),
            unstack_layer_tree(export_params(model)))
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("GPT FEATURES", tuple(out.shape), len(served))
"""


def test_port_decodes_quantizes_and_scans_with_reference_blocked():
    """generate over a bf16 cache, weight-only int8 serving held against
    generate, and a bf16 Adam step of a scan + remat + MoE GPT whose
    tree unstacks into a decoder, in a process that cannot import jax."""
    code = _GPT_FEATURES_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "GPT FEATURES (2, 11) 5" in proc.stdout


@pytest.mark.parametrize("module", [
    "serving/fleet.py", "parallel/heartbeat.py", "observability/catalog.py",
    "observability/trace.py", "observability/flight.py",
    "observability/watchdog.py", "observability/exporter.py"])
def test_ast_scan_covers_the_fleet_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_FLEET_BLOCKED = _SERVE_BLOCKED.split("cfg = GPTConfig.tiny()")[0] + r"""
import copy
from paddle_tpu_torch.observability import exporter, flight, watchdog
from paddle_tpu_torch.serving import FleetConfig, FleetRouter
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
model = GPTDecoder(cfg, device="cpu")
sc = ServeConfig(num_slots=2, page_size=8, max_len=64, prefill_len=16)
rs = np.random.RandomState(0)
prompts = [rs.randint(0, 512, n) for n in (5, 20, 9, 30, 12, 7)]
router = FleetRouter(model, FleetConfig(num_replicas=3, prefill_replicas=1),
                     serve_config=sc, sleep=lambda s: None)
fids = [router.submit(p, max_new=6) for p in prompts]
for _ in range(2):
    router.step()
router.kill_replica(max((1, 2), key=lambda i: router._replicas[i].load()))
router.deploy(copy.deepcopy(model), version="v1")
router.drain()
alone = ServingEngine(model, sc)
rids = [alone.submit(p, max_new=6) for p in prompts]
alone.drain()
assert [router.requests[f].tokens for f in fids] \
    == [alone.requests[r].tokens for r in rids]
tel = router.telemetry()
assert router.failovers == 1 and tel["handoffs"] == 2
assert tel["versions"] == ["v1"] * 3
assert "fleet_replicas" in exporter.render_prometheus()
router.close()
assert sum(core.launch_counts().values()) == 0      # CPU: plain versions
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("FLEET SERVED", tel["states"], tel["handoffs"])
"""


def test_port_fleet_serves_with_reference_and_triton_blocked():
    """Three replicas (one prefill) with a kill, handoffs and a rolling
    deploy, token-exact against one engine, in a process that cannot
    import jax."""
    code = _FLEET_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "FLEET SERVED ['draining', 'draining', 'draining'] 2" \
        in proc.stdout


def test_fleet_router_needs_a_model():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.serving import FleetRouter
    with pytest.raises(EnforceError):
        FleetRouter()


@pytest.mark.parametrize("module", [
    "parallel/launch.py", "data/loader.py", "serving/engine.py",
    "serving/fleet.py", "core/retry.py"])
def test_ast_scan_covers_the_process_fleet_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


def test_chip_smoke_fleet_worker_imports_nothing_of_the_reference():
    """chip_smoke.py's subprocess replica worker is chip_smoke.py itself
    (``--fleet-worker``): the scan of the whole file covers it, and the
    worker function's own imports name no blocked package."""
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    worker = [n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "fleet_worker"]
    assert len(worker) == 1
    roots = set()
    for node in ast.walk(worker[0]):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "paddle_tpu_torch" in roots
    assert not roots & set(BLOCKED)
    assert not _imported_roots(path) & set(BLOCKED)


_PROCESS_FLEET_BLOCKED = _SERVE_BLOCKED.split("cfg = GPTConfig.tiny()")[0] \
    + r"""
import tempfile, threading
from paddle_tpu_torch.data import DataLoader
from paddle_tpu_torch.parallel import launch
from paddle_tpu_torch.serving import fleet
cfg = GPTConfig.tiny()
cfg.dropout = 0.0
eng = ServingEngine(GPTDecoder(cfg, device="cpu"), ServeConfig(
    num_slots=2, page_size=8, max_len=48, prefill_len=8))
rs = np.random.RandomState(0)
for n in (5, 20, 9):
    eng.submit(rs.randint(0, 512, n), max_new=4)
done = eng.drain()
assert eng.staged_prefills == eng.prefill_calls == 6
batches = list(DataLoader.from_generator(
    lambda: ((np.full(3, i, np.float32),) for i in range(10)), 4,
    shuffle=True, shuffle_buffer=4, device="cpu"))
xdir = tempfile.mkdtemp()
peer = threading.Thread(target=launch.host_allgather, args=(
    fleet._pack({{"ok": 1}}), 1, 2, xdir, "t"), kwargs=dict(ragged=True))
peer.start()
got = launch.host_allgather(fleet._pack({{}}), 0, 2, xdir, "t",
                            ragged=True)
peer.join()
assert fleet._unpack(got[1]) == {{"ok": 1}}
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("PROCESS FLEET PARTS", len(done), len(batches))
"""


def test_process_fleet_parts_run_with_reference_and_triton_blocked():
    """Staged prompts, the DataLoader and the file all-gather with the
    fleet's wire, in a process that cannot import jax."""
    code = _PROCESS_FLEET_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "PROCESS FLEET PARTS 3 2" in proc.stdout


#: what would load the JAX package's own native build: the repository
#: root's ``csrc/build`` (the port builds into ``paddle_tpu_torch/csrc/
#: build``), its library's name, or the environment variable naming it
_FOREIGN_BUILD = re.compile(r"(?<!paddle_tpu_torch/)\bcsrc/build|"
                            r"PT_DATAIO_LIB|libptdataio")


def _foreign_build_refs(text):
    return _FOREIGN_BUILD.findall(text)


def test_no_port_file_names_the_reference_native_build():
    assert _foreign_build_refs('os.environ.get("PT_DATAIO_LIB")')
    assert _foreign_build_refs('"csrc/build/libptdataio.so"')
    assert not _foreign_build_refs("paddle_tpu_torch/csrc/build/<hash>/")
    bad = {}
    for path in _port_files():
        with open(path) as f:
            found = _foreign_build_refs(f.read())
        if found:
            bad[os.path.relpath(path, ROOT)] = found
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "data/formats.py", "data/native.py", "data/dataset.py",
    "distributions.py", "ops/graph.py", "ops/tail.py", "ops/vision.py",
    "models/word2vec.py"])
def test_ast_scan_covers_the_op_surface_modules(module):
    path = os.path.join(ROOT, "paddle_tpu_torch", *module.split("/"))
    assert path in _port_files()
    assert not _imported_roots(path) & set(BLOCKED)


_W2V_BLOCKED = _SERVE_BLOCKED.split("from paddle_tpu_torch.models")[0] \
    + r"""
import os, tempfile
sys.path.insert(0, os.path.join({root!r}, "tools"))
import torch_word2vec as book
from paddle_tpu_torch.ops.cuda import core
with tempfile.TemporaryDirectory() as tmp:
    corpus = book.zipf_corpus(os.path.join(tmp, "c.txt"), lines=60,
                              words=200)
    word_idx, grams = book.book_grams([corpus])
    paths, written = book.write_grams(grams, tmp)
    raw, read, _ = book.read_grams(paths, threads=2)
assert book.same_records(written, raw)
bs = book.batches(read, 32, 2)
w2v, sg, _, _ = book.train("cpu", len(word_idx), bs,
                           book.negatives(32 * 4, 2))
assert all(np.isfinite(w2v + sg))
assert sum(core.launch_counts().values()) == 0
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("WORD2VEC", len(w2v), len(sg))
"""


def test_word2vec_book_path_runs_with_reference_and_triton_blocked():
    """The corpus, the native reader and both word2vec models, in a
    process that cannot import jax."""
    code = _W2V_BLOCKED.format(blocked=BLOCKED, root=ROOT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    assert "WORD2VEC 2 2" in proc.stdout


def test_word2vec_models_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.models import SkipGramNCE, Word2Vec
    with pytest.raises(EnforceError):
        SkipGramNCE(64, 8, 4)
    with pytest.raises(EnforceError):
        Word2Vec(64, 8)
