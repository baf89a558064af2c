"""The port's Trainer, CheckpointManager and TrainGuardian against the
JAX package's, on the CPU.

Models: the JAX example's BERT step (``examples/pretrain_bert_flash.py``
at ``--tiny``: ``BertConfig.tiny()``, Adam 1e-4, padded batches, the
materialized-logits pretraining loss) run in f32, since bf16 rounds at
other places in the two frameworks (the bar of the bf16 tests is 2e-2);
the chip phase's recipe (``amp.decorate(AdamW)``, warm-up into a
polynomial decay, global-norm clip, layer-norm and bias parameters
excluded from decay) on a tiny BERT with dropout 0.1 for the resume and
rollback runs; and the JAX guardian tests' one-weight linear regression
for the ladder. Data comes from seeded, seekable datasets.

Tolerances: the port's Trainer against the JAX Trainer within 1e-5 per
step; a resumed, rolled-back or guarded run against the uninterrupted
run bit for bit (the CPU is deterministic, dropout masks included);
linear-regression weights within 1e-6.
"""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


# ------------------------------------------------ linear regression (JAX's)

def _linreg_step(lr=0.05):
    def step(state, x, y):
        pred = state["w"] * x + state["b"]
        loss = jnp.mean((pred - y) ** 2)
        gw = jnp.mean(2.0 * (pred - y) * x)
        gb = jnp.mean(2.0 * (pred - y))
        return loss, {"w": state["w"] - lr * gw, "b": state["b"] - lr * gb}
    return step


def _batch(i, poison=None):
    rng = np.random.RandomState(1000 + i)
    x = rng.randn(8).astype(np.float32)
    y = (3.0 * x).astype(np.float32)
    if poison == "nan":
        x = np.full_like(x, np.nan)
    elif poison == "spike":
        x, y = x * 1e4, y * 1e4
    return x, y


class _SeekableDS:
    """Index-keyed deterministic stream; ``faults`` maps index -> poison
    kind."""

    def __init__(self, n, faults=None, make=_batch):
        self.n = n
        self.pos = 0
        self.faults = dict(faults or {})
        self.make = make

    def seek(self, step):
        self.pos = int(step)

    def reader(self):
        def feed():
            i = self.pos
            while i < self.n:
                yield self.make(i, self.faults.get(i))
                i += 1
        return feed


class LinReg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.b = torch.nn.Parameter(torch.zeros(()))


def _linreg_loss(m, x, y):
    return torch.mean((m.w * x + m.b - y) ** 2)


def _port_trainer(cfg, lr=0.05):
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer
    model = LinReg()
    return Trainer(model, SGD(model.parameters(), lr), _linreg_loss, cfg,
                   device="cpu")


def _jax_state0():
    return {"w": jnp.zeros(()), "b": jnp.zeros(())}


# ------------------------------------------------------------ tiny BERT

def _bert_batch(cfg, b, seq):
    def make(i, poison=None):
        rs = np.random.RandomState(100 + i)
        ids = rs.randint(0, cfg.vocab_size, (b, seq)).astype(np.int32)
        mlm_l = rs.randint(0, cfg.vocab_size, (b, seq)).astype(np.int32)
        nsp_l = rs.randint(0, 2, (b,)).astype(np.int32)
        mmask = (rs.rand(b, seq) < 0.15).astype(np.float32)
        lens = rs.randint(seq // 2, seq + 1, (b,))
        amask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.float32)
        return ids, mlm_l, nsp_l, mmask, amask
    return make


def _port_bert_loss(m, ids, mlm_l, nsp_l, mmask, amask):
    from paddle_tpu_torch.models.bert import pretrain_loss
    mlm, nsp = m(ids.long(), attention_mask=amask)
    return pretrain_loss(mlm, nsp, mlm_l.long(), nsp_l.long(), mmask)


def test_trainer_matches_the_jax_trainer_on_the_example_step(tmp_path):
    import paddle_tpu as pt
    from paddle_tpu.models.bert import BertConfig, BertForPretraining
    from paddle_tpu.models.bert import pretrain_loss
    from paddle_tpu.static.trainer import Trainer, TrainerConfig
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.models.bert import BertConfig as PConfig
    from paddle_tpu_torch.models.bert import BertForPretraining as PModel
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import Trainer as PTrainer
    from paddle_tpu_torch.static import TrainerConfig as PTrainerConfig
    cfg = BertConfig.tiny()
    cfg.dropout = 0.0
    model = BertForPretraining(cfg)
    params = model.init(jax.random.key(0))["params"]
    opt = pt.optimizer.Adam(1e-4)

    def loss_fn(p, ids, mlm_l, nsp_l, mmask, amask):
        mlm, nsp = model.apply({"params": p, "state": {}}, ids,
                               attention_mask=amask)
        return pretrain_loss(mlm, nsp, mlm_l, nsp_l, mmask), 0.0

    @jax.jit
    def train_step(state, *batch):
        loss, params, opt_state, _ = opt.minimize(
            loss_fn, state["params"], state["opt"], *batch)
        return loss, {"params": params, "opt": opt_state}

    make = _bert_batch(cfg, 2, 32)
    kw = dict(max_steps=8, log_every=1, num_ingest_threads=1,
              checkpoint_every=2)
    jtr = Trainer(train_step, TrainerConfig(
        checkpoint_dir=str(tmp_path / "jax"), **kw))
    jtr.train({"params": params, "opt": opt.init(params)},
              _SeekableDS(100, make=make))
    pcfg = PConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_position", "type_vocab_size")},
        dropout=0.0)
    pm = PModel(pcfg, device="cpu")
    bridge.load_params(pm, jax.tree_util.tree_map(np.asarray, params))
    ptr = PTrainer(pm, Adam(pm.parameters(), 1e-4), _port_bert_loss,
                   PTrainerConfig(checkpoint_dir=str(tmp_path / "port"),
                                  **kw), device="cpu")
    stats = ptr.train(_SeekableDS(100, make=make))
    assert stats["steps"] == 8
    assert [s for s, _ in ptr.history] == [s for s, _ in jtr.history]
    np.testing.assert_allclose([v for _, v in ptr.history],
                               [v for _, v in jtr.history], rtol=1e-5,
                               atol=1e-5)
    assert sorted(int(d) for d in os.listdir(tmp_path / "port")
                  if d.isdigit()) == [4, 6, 8]


def _recipe_run(ckpt_dir, max_steps, plan=None, guardian=True, every=4,
                seed=0):
    """The chip phase's recipe on a tiny BERT with dropout 0.1: returns
    (trainer, losses by step, model, optimizer)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW, ClipByGlobalNorm
    from paddle_tpu_torch.optimizer import lr_scheduler as S
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    cfg = BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64, max_position=32,
                     dropout=0.1)
    model = BertForPretraining(cfg, device="cpu", seed=seed)
    sched = S.linear_lr_warmup(S.polynomial_decay(1e-3, 16, 0.0), 4, 0.0,
                               1e-3)
    opt = amp.decorate(AdamW(
        model.named_parameters(), sched, weight_decay=0.01,
        decay_mask_fn=lambda n: not n.endswith(("bias", "scale")),
        grad_clip=ClipByGlobalNorm(1.0)), amp.bf16_policy())
    losses = {}

    def loss_fn(m, *batch):
        loss = _port_bert_loss(m, *batch)
        if plan is not None and plan.check("loss"):
            loss = loss * float("nan")
        return loss

    cfg_t = TrainerConfig(max_steps=max_steps, num_ingest_threads=1,
                          checkpoint_dir=ckpt_dir, checkpoint_every=every,
                          guardian=guardian, log_every=1)
    tr = Trainer(model, opt, loss_fn, cfg_t, device="cpu")
    tr.train(_SeekableDS(1000, make=_bert_batch(cfg, 2, 16)))
    for s, v in tr.history:
        losses[s] = v
    return tr, losses, model, opt


def _state_bits(model, opt):
    named = dict(model.named_parameters())
    from paddle_tpu_torch.io.checkpoint import _flatten
    return {k: v.clone() for k, v in _flatten(
        {"params": named, "opt": opt.state_tree(named)}).items()}


def test_resume_equals_the_uninterrupted_run_bitwise(tmp_path):
    _, ref, m0, o0 = _recipe_run(None, 8, every=0)
    _, first, _, _ = _recipe_run(str(tmp_path / "ck"), 5, every=5)
    tr, second, m1, o1 = _recipe_run(str(tmp_path / "ck"), 8, every=5,
                                     seed=99)   # other weights: restored
    assert sorted(first) == [1, 2, 3, 4, 5]
    assert sorted(second) == [6, 7, 8]
    for s, v in {**first, **second}.items():
        assert v == ref[s], (s, v, ref[s])
    want, got = _state_bits(m0, o0), _state_bits(m1, o1)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert torch.equal(m0.dropout_gen.get_state(), m1.dropout_gen.get_state())


def test_guardian_ladder_skips_rereads_rolls_back_and_replays(tmp_path):
    from paddle_tpu_torch.testing.chaos import FaultPlan
    _, ref, m0, o0 = _recipe_run(None, 16, every=0)
    plan = FaultPlan().poison("loss", nth=6, times=3)   # steps 6, 7, 8
    tr, got, m1, o1 = _recipe_run(str(tmp_path / "ck"), 16, plan=plan)
    g = tr.guardian
    actions = [r["action"] for r in g.log if "action" in r]
    assert actions == ["skip", "reread", "rollback"]
    assert g.rollbacks == 1 and g.skips == 3 and plan.fired() == 3
    assert [r["restored_step"] for r in g.log
            if r["guardian"] == "rollback_done"] == [4]
    # the replay from step 4 on equals the uninterrupted run
    for s in range(5, 17):
        assert got[s] == ref[s], (s, got[s], ref[s])
    want, have = _state_bits(m0, o0), _state_bits(m1, o1)
    for k in want:
        assert torch.equal(want[k], have[k]), k


# ------------------------------------------------------------ checkpoints

def _ck_state(v, dtype=torch.float32):
    return {"params": {"enc.w": torch.full((4, 3), v, dtype=dtype),
                       "b": torch.tensor(v)},
            "opt": {"step": torch.tensor(int(v), dtype=torch.int32)}}


def _corrupt(path, key, fn):
    f = os.path.join(path, "state.pt")
    data = torch.load(f, weights_only=True)
    data[key] = fn(data[key])
    torch.save(data, f)


def test_checkpoint_manifest_and_meta_round_trip(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager, crc_manifest
    mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=2)
    state = _ck_state(1.5, torch.bfloat16)
    assert mgr.save(2, state, meta={"cursor": 2, "rng": {"g": [1, 2]}})
    assert not mgr.save(3, state)              # interval gate
    assert mgr.save(3, state, force=True)      # force bypasses it
    mgr.wait()                                 # the saves land
    assert mgr.read_meta(2) == {"cursor": 2, "rng": {"g": [1, 2]}}
    assert mgr.read_meta(99) == {}
    assert mgr.steps() == [2, 3]
    restored, at = mgr.restore(state)
    assert at == 3
    assert crc_manifest(restored) == crc_manifest(state)
    assert restored["params"]["enc.w"].dtype == torch.bfloat16
    with open(tmp_path / "ck" / "2.meta.json") as f:
        man = json.load(f)["crc32"]
    assert man["params/enc.w"]["dtype"] == "torch.bfloat16"
    for s in (4, 6, 8):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.steps() == [4, 6, 8]            # max_to_keep = 3
    assert sorted(p for p in os.listdir(tmp_path / "ck")
                  if p.endswith(".meta.json")) == [
        "4.meta.json", "6.meta.json", "8.meta.json"]
    with pytest.raises(ValueError):            # the template's shapes
        mgr.restore({"params": {"enc.w": torch.zeros(2, 3),
                                "b": torch.tensor(0.0)},
                     "opt": {"step": torch.tensor(0, dtype=torch.int32)}},
                    step=8)


def test_corrupt_leaf_degrades_to_previous_step(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _ck_state(1.0))
    mgr.save(2, _ck_state(2.0))
    mgr.wait()
    # silent bit rot: a valid file, plausible values, wrong bytes
    _corrupt(str(tmp_path / "ck" / "2"), "params/enc.w", lambda x: x + 0.5)
    restored, at = mgr.restore(_ck_state(0.0))
    assert at == 1 and float(restored["params"]["b"]) == 1.0
    restored, at = mgr.restore(_ck_state(0.0), verify=False)
    assert at == 2 and float(restored["params"]["enc.w"][0, 0]) == 2.5


def test_every_candidate_corrupt_raises(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _ck_state(1.0))
    mgr.wait()
    _corrupt(str(tmp_path / "ck" / "1"), "params/b", lambda x: x * 3.0)
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(_ck_state(0.0))
    with open(tmp_path / "ck" / "1" / "state.pt", "wb") as f:
        f.write(b"torn")                        # unreadable
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(_ck_state(0.0))


def test_fault_mid_save_leaves_no_listed_step(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.testing import chaos
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _ck_state(1.0))
    mgr.wait()
    plan = chaos.FaultPlan().fail("fault_point", path=r"^checkpoint\.save$")
    with chaos.active(plan):
        mgr.save(2, _ck_state(2.0))            # the write runs behind
        with pytest.raises(chaos.InjectedFault):
            mgr.wait()                         # and its failure surfaces
    assert plan.fired() == 1
    assert mgr.steps() == [1]
    assert not [p for p in os.listdir(tmp_path / "ck") if p.startswith(".")]
    restored, at = mgr.restore(_ck_state(0.0))
    assert at == 1
    assert mgr.save(2, _ck_state(2.0))
    mgr.wait()
    assert mgr.steps() == [1, 2]


def test_generator_state_is_json_safe():
    from paddle_tpu_torch.core import random as R
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Dpsgd
    m = BertForPretraining(BertConfig(vocab_size=64, hidden_size=32,
                                      num_layers=1, num_heads=2,
                                      intermediate_size=64, max_position=32),
                           device="cpu")
    opt = Dpsgd(m.parameters(), 0.1)
    gens = R.step_generators(m, opt)
    assert sorted(gens) == ["dropout_gen", "optimizer"]
    snap = json.loads(json.dumps(R.get_state(gens)))
    a = [torch.rand(4, generator=g) for g in gens.values()]
    R.set_state(gens, snap)
    b = [torch.rand(4, generator=g) for g in gens.values()]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(KeyError):
        R.set_state(gens, {"dropout_gen": snap["dropout_gen"]})


# -------------------------------------------------------------- guardian

SEQUENCES = {
    "ladder_relatch": [(1.0 + 0.01 * i, True) for i in range(6)] + [
        (500.0, True)] * 3 + [(1.0, True), (500.0, True)],
    "spike_needs_min_samples": [(1.0, True), (500.0, True)],
    "nonfinite_skips": [(1.0, True)] * 5 + [(float("nan"), False),
                                            (float("inf"), False),
                                            (1.1, True), (float("nan"), True),
                                            (float("nan"), False),
                                            (float("nan"), False)],
    "spike_then_nonfinite": [(1.0, True)] * 8 + [(50.0, True),
                                                 (float("nan"), False),
                                                 (60.0, True), (1.0, True)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_classify_matches_jax(name):
    from paddle_tpu.static.guardian import GuardianConfig as JC
    from paddle_tpu.static.guardian import TrainGuardian as JG
    from paddle_tpu_torch.static import GuardianConfig, TrainGuardian
    kw = dict(min_samples=4, spike_factor=10.0, rollback_budget=3)
    jg, pg = JG(JC(**kw)), TrainGuardian(GuardianConfig(**kw))
    for i, (loss, applied) in enumerate(SEQUENCES[name]):
        want = jg._classify(i + 1, loss, applied)
        assert pg._classify(i + 1, loss, applied) == want, (i, loss)
        assert (pg.episode, pg.episode_start, pg.rollback_bound,
                pg.healthy()) == (jg.episode, jg.episode_start,
                                  jg.rollback_bound, jg.healthy())
    assert (pg.skips, pg.spikes) == (jg.skips, jg.spikes)
    assert pg.state_dict() == jg.state_dict()
    again = TrainGuardian(GuardianConfig(**kw))
    again.load_state(pg.state_dict())
    assert again.state_dict() == pg.state_dict()


def test_nonfinite_skip_matches_the_jax_trainer():
    from paddle_tpu.static import Trainer, TrainerConfig
    from paddle_tpu_torch.static import TrainerConfig as PConfig
    kw = dict(num_ingest_threads=1, prefetch=False, max_steps=10,
              guardian=True)
    jtr = Trainer(_linreg_step(), TrainerConfig(**kw))
    jstate, _ = jtr.train(_jax_state0(), _SeekableDS(10, {4: "nan"}))
    ptr = _port_trainer(PConfig(**kw))
    stats = ptr.train(_SeekableDS(10, {4: "nan"}))
    assert stats["steps"] == 10
    assert ptr.guardian.skips == jtr.guardian.skips == 1
    np.testing.assert_allclose(ptr.model.w.item(), float(jstate["w"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ptr.model.b.item(), float(jstate["b"]),
                               rtol=1e-6, atol=1e-6)


def test_rollback_budget_runs_out_into_training_diverged(tmp_path):
    from paddle_tpu_torch.static import (GuardianConfig, TrainerConfig,
                                         TrainingDiverged)
    ds = _SeekableDS(100, faults={i: "spike" for i in range(4, 100)})
    tr = _port_trainer(TrainerConfig(
        num_ingest_threads=1, prefetch=False, max_steps=50,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        guardian=GuardianConfig(min_samples=4, rollback_budget=1)))
    with pytest.raises(TrainingDiverged, match="rollback budget"):
        tr.train(ds)
    assert tr.guardian.rollbacks == 1
    assert tr.guardian.spikes == 1


def test_rollback_without_seek_is_refused(tmp_path):
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.static import GuardianConfig, TrainerConfig

    def unseekable():
        for i in range(100):
            yield _batch(i, "spike" if i >= 4 else None)
    tr = _port_trainer(TrainerConfig(
        num_ingest_threads=1, prefetch=False, max_steps=50,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        guardian=GuardianConfig(min_samples=4)))
    with pytest.raises(EnforceError, match="seekable"):
        tr.train(lambda: unseekable())


def test_guardian_fetches_are_trailing(monkeypatch):
    from paddle_tpu_torch.static import TrainerConfig, TrainGuardian
    processed = []
    orig = TrainGuardian._process

    def spy(self, step, loss, applied):
        current = self._pending[0] if self._pending else None
        processed.append((step, current))
        return orig(self, step, loss, applied)

    monkeypatch.setattr(TrainGuardian, "_process", spy)
    tr = _port_trainer(TrainerConfig(num_ingest_threads=1, prefetch=False,
                                     max_steps=6, guardian=True))
    tr.train(_SeekableDS(10))
    mid_run = [(p, c) for p, c in processed if c is not None]
    assert len(mid_run) == 5
    for fetched, parked in mid_run:
        assert fetched < parked      # the fetch is a full step behind
    assert processed[-1][1] is None  # flush_trailing drained the last one


# ------------------------------------------- preemption, ingest, config

def test_preempted_exits_75_after_saving(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import (PREEMPTED_EXIT_CODE, Preempted,
                                         Trainer, TrainerConfig)
    calls = []

    def loss_fn(m, x, y):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return _linreg_loss(m, x, y)

    model = LinReg()
    tr = Trainer(model, SGD(model.parameters(), 0.05), loss_fn,
                 TrainerConfig(num_ingest_threads=1, max_steps=10,
                               checkpoint_dir=str(tmp_path / "ck"),
                               checkpoint_every=100, handle_preemption=True),
                 device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as info:
        tr.train(_SeekableDS(20))
    assert info.value.code == PREEMPTED_EXIT_CODE == 75
    assert info.value.step == 3 and len(calls) == 3
    assert signal.getsignal(signal.SIGTERM) == before
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.steps() == [3] and mgr.read_meta(3)["cursor"] == 3


class _SplitReaders:
    """One reader dies after a single item; the other supplies plenty."""

    def __init__(self, good_items=60):
        self.good_items = good_items

    def readers(self, n):
        def bad():
            yield _batch(0)
            raise ValueError("reader exploded")

        def good():
            for i in range(self.good_items):
                yield _batch(i)
        return [bad, good]


@pytest.mark.parametrize("fail_fast", [True, False])
def test_dead_ingest_reader(fail_fast):
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    steps_run = []

    def loss_fn(m, x, y):
        steps_run.append(1)
        return _linreg_loss(m, x, y)

    model = LinReg()
    tr = Trainer(model, SGD(model.parameters(), 0.05), loss_fn,
                 TrainerConfig(num_ingest_threads=2, prefetch=False,
                               ingest_fail_fast=fail_fast), device="cpu")
    with pytest.raises(RuntimeError, match="ingestion thread failed") as e:
        tr.train(_SplitReaders(good_items=40))
    assert isinstance(e.value.__cause__, ValueError)
    if fail_fast:
        assert len(steps_run) < 30   # aborted, did not drain 41 items
    else:
        assert len(steps_run) == 41  # every surviving item trained on


def test_batch_size_collates_samples():
    from paddle_tpu_torch.data import batch
    from paddle_tpu_torch.static import TrainerConfig

    def samples():
        for i in range(40):
            x, y = _batch(i // 8)
            yield x[i % 8], y[i % 8]

    a = _port_trainer(TrainerConfig(num_ingest_threads=1))
    a.train(lambda: samples(), batch_size=8)
    b = _port_trainer(TrainerConfig(num_ingest_threads=1))
    b.train(batch(lambda: samples(), 8))
    assert torch.equal(a.model.w, b.model.w)
    assert a.model.w.item() != 0.0


UNPORTED = {
    "heartbeat": True, "heartbeat_transport": "kv", "heartbeat_dir": "/x",
    "heartbeat_timeout_s": 1.0, "heartbeat_interval_s": 1.0,
    "heartbeat_kv_client": object(), "on_peer_stall": print,
    "telemetry": object(), "watchdog": True, "mesh_plan": object(),
}
#: of the options the port refused before its Trainer runtime landed,
#: these still raise; every other one is ported and must run
STILL_UNPORTED = ("heartbeat_transport", "heartbeat_kv_client", "mesh_plan",
                  "scaler_state_fn")


@pytest.mark.parametrize("field", sorted(UNPORTED) + [
    "mirror", "strict_mirror", "scaler_state_fn", "num_workers"])
def test_unported_option_raises(field, tmp_path):
    """Each option that is still not ported raises NotImplementedError;
    each one ported since runs a two-step Trainer (or a mirrored save)."""
    from paddle_tpu_torch.io import CheckpointManager, fs
    from paddle_tpu_torch.observability import TelemetryConfig
    from paddle_tpu_torch.static import (GuardianConfig, TrainerConfig,
                                         TrainGuardian)
    if field in STILL_UNPORTED:
        with pytest.raises(NotImplementedError):
            if field in UNPORTED:
                _port_trainer(TrainerConfig(**{field: UNPORTED[field]}))
            else:
                TrainGuardian(GuardianConfig(scaler_state_fn=lambda s: s))
        return
    hb = str(tmp_path / "hb")
    ported = {"heartbeat": dict(heartbeat=True, heartbeat_dir=hb),
              "heartbeat_dir": dict(heartbeat_dir=hb),
              "heartbeat_timeout_s": dict(heartbeat=True, heartbeat_dir=hb,
                                          heartbeat_timeout_s=1.0),
              "heartbeat_interval_s": dict(heartbeat=True, heartbeat_dir=hb,
                                           heartbeat_interval_s=1.0),
              "on_peer_stall": dict(heartbeat=True, heartbeat_dir=hb,
                                    on_peer_stall=print),
              "telemetry": dict(telemetry=TelemetryConfig(enabled=True)),
              "watchdog": dict(watchdog=True)}
    if field == "mirror":
        fs.register_filesystem("ptmirror", fs.MemFS())
        url = f"ptmirror://{tmp_path.name}/ck"
        with CheckpointManager(url) as mgr:
            mgr.save(1, _ck_state(1.0))
        assert fs.fs_exists(f"{url}/1/COMMIT")
        return
    if field == "strict_mirror":
        with CheckpointManager(str(tmp_path), strict_mirror=True) as mgr:
            assert mgr.strict_mirror
        return
    tr = _port_trainer(TrainerConfig(num_ingest_threads=1, max_steps=2,
                                     **ported.get(field, {})))
    kw = dict(num_workers=2, worker_id=0) if field == "num_workers" else {}
    assert tr.train(_SeekableDS(4), **kw)["steps"] == 2


def test_trainer_needs_the_card_unless_asked_for_the_cpu():
    from paddle_tpu_torch.core.enforce import EnforceError
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer
    m = LinReg()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(EnforceError, match="CUDA"):
        Trainer(m, SGD(m.parameters(), 0.1), _linreg_loss)
    assert math.isfinite(float(m.w))


# ------------------------------------- batch-norm state (fault 11)

def _bn_batch(i, poison=None):
    rs = np.random.RandomState(2000 + i)
    x = (rs.randn(8, 4) * 2.0 + 1.0).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    if poison == "nan":
        x[0, 0] = np.nan
    return x, y


def _bn_loss(m, x, y):
    return torch.mean((m(x) - y) ** 2)


def _bn_trainer(cfg, seed_buffers=False):
    from paddle_tpu_torch.nn import BatchNorm
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer
    model = BatchNorm(4)
    return Trainer(model, SGD(model.parameters(), 0.1), _bn_loss, cfg,
                   device="cpu")


def test_refused_step_keeps_batch_norm_statistics_as_jax_does():
    """A NaN in the batch of step 3: both Trainers refuse the step, and
    the port's running statistics equal the JAX Trainer's state (which
    gates every leaf) within 1e-6 and stay finite."""
    import paddle_tpu as pt
    from paddle_tpu.static import Trainer, TrainerConfig
    from paddle_tpu_torch.static import TrainerConfig as PConfig
    bn = pt.nn.BatchNorm(4)
    v = bn.init(jax.random.PRNGKey(0))
    opt = pt.optimizer.SGD(0.1)

    def step(st, x, y):
        def lf(p):
            out, ns = bn.apply({"params": p, "state": st["bn"]}, x,
                               training=True)
            return jnp.mean((out - y) ** 2), ns
        (loss, ns), g = jax.value_and_grad(lf, has_aux=True)(st["params"])
        p, o = opt.apply_gradients(st["params"], g, st["opt"])
        return loss, {"params": p, "opt": o, "bn": ns}

    kw = dict(num_ingest_threads=1, prefetch=False, max_steps=6,
              guardian=True)
    jtr = Trainer(step, TrainerConfig(**kw))
    jst, _ = jtr.train({"params": v["params"], "opt": opt.init(v["params"]),
                        "bn": v["state"]},
                       _SeekableDS(6, {2: "nan"}, make=_bn_batch))
    ptr = _bn_trainer(PConfig(**kw))
    ptr.train(_SeekableDS(6, {2: "nan"}, make=_bn_batch))
    assert ptr.guardian.skips == jtr.guardian.skips == 1
    for name in ("mean", "variance"):
        got = getattr(ptr.model, name)
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(jst["bn"][name]),
                                   rtol=1e-6, atol=1e-6)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(
            getattr(ptr.model, name).detach().numpy(),
            np.asarray(jst["params"][name]), rtol=1e-6, atol=1e-6)


def test_batch_norm_statistics_resume_bitwise(tmp_path):
    """Saved at 4, resumed onto a fresh model and run to 8: the running
    statistics equal the uninterrupted run's bit for bit."""
    from paddle_tpu_torch.static import TrainerConfig
    ref = _bn_trainer(TrainerConfig(num_ingest_threads=1, max_steps=8))
    ref.train(_SeekableDS(20, make=_bn_batch))
    ck = str(tmp_path / "ck")
    kw = dict(num_ingest_threads=1, checkpoint_dir=ck, checkpoint_every=4)
    _bn_trainer(TrainerConfig(max_steps=6, **kw)).train(
        _SeekableDS(20, make=_bn_batch))
    again = _bn_trainer(TrainerConfig(max_steps=8, **kw))
    assert sorted(again.state()) == ["buffers", "opt", "params"]
    again.train(_SeekableDS(20, make=_bn_batch))
    for name, b in ref.model.named_buffers():
        assert torch.equal(b, dict(again.model.named_buffers())[name]), name
    for name, p in ref.model.named_parameters():
        assert torch.equal(p, dict(again.model.named_parameters())[name])


def test_checkpoint_without_buffers_restores_with_a_warning(tmp_path,
                                                            capsys):
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.static import TrainerConfig
    ck = str(tmp_path / "ck")
    old = _bn_trainer(TrainerConfig())
    with torch.no_grad():
        old.model.scale.fill_(2.0)
    st = old.state()
    with CheckpointManager(ck) as mgr:   # a checkpoint of the older form
        mgr.save(4, {"params": st["params"], "opt": st["opt"]})
    tr = _bn_trainer(TrainerConfig(num_ingest_threads=1, max_steps=4,
                                   checkpoint_dir=ck, checkpoint_every=4))
    with torch.no_grad():
        tr.model.mean.fill_(0.25)
    assert tr.train(_SeekableDS(20, make=_bn_batch))["steps"] == 4
    assert float(tr.model.scale[0]) == 2.0
    assert torch.equal(tr.model.mean, torch.full((4,), 0.25))
    assert "holds no 'buffers'" in capsys.readouterr().out


def test_guardian_counters_match_the_jax_guardian(tmp_path):
    """The same poisoned run (NaN at 4-6: skip, re-read, roll back; then
    a spike) through both Trainers: the registries' skip, spike and
    rollback counters move by the same amounts."""
    from paddle_tpu.observability import metrics as JM
    from paddle_tpu.static import GuardianConfig as JG
    from paddle_tpu.static import Trainer, TrainerConfig
    from paddle_tpu_torch.observability import metrics as PM
    from paddle_tpu_torch.static import GuardianConfig, TrainerConfig as PC
    names = ("trainer.nonfinite_skips", "trainer.loss_spikes",
             "trainer.rollbacks")
    faults = {4: "nan", 5: "nan", 6: "nan", 14: "spike"}

    class Once(_SeekableDS):
        """Each fault fires once: the replay after a rollback is clean
        (a channel of 2 keeps the readers from running far ahead)."""

        def __init__(self):
            super().__init__(40, dict(faults))
            self.make = self._make

        def _make(self, i, poison):
            self.faults.pop(i, None)
            return _batch(i, poison)

    def deltas(reg, run):
        before = [reg.counter(n).total() for n in names]
        run()
        return [reg.counter(n).total() - b for n, b in zip(names, before)]

    kw = dict(num_ingest_threads=1, prefetch=False, max_steps=18,
              checkpoint_every=2, channel_capacity=2)
    jtr = Trainer(_linreg_step(), TrainerConfig(
        checkpoint_dir=str(tmp_path / "j"), guardian=JG(min_samples=4),
        **kw))
    j = deltas(JM, lambda: jtr.train(_jax_state0(), Once()))
    ptr = _port_trainer(PC(checkpoint_dir=str(tmp_path / "p"),
                           guardian=GuardianConfig(min_samples=4), **kw))
    p = deltas(PM, lambda: ptr.train(Once()))
    assert j == p
    assert p[0] == 3 and p[1] >= 1 and p[2] >= 1
    assert [r["guardian"] for r in ptr.guardian.log][:5] == [
        "nonfinite", "nonfinite", "nonfinite", "rollback", "rollback_done"]
    assert (ptr.guardian.skips, ptr.guardian.spikes, ptr.guardian.rollbacks
            ) == (jtr.guardian.skips, jtr.guardian.spikes,
                  jtr.guardian.rollbacks)


# ---------------------------------------- heartbeats and the watchdog

def test_killed_peer_detected(tmp_path):
    import time as _time
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.heartbeat import FileHeartbeat
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    hbdir = str(tmp_path / "hb")
    peer = FileHeartbeat(hbdir, 1)      # pinged once, then died
    peer.ping()
    old = _time.time() - 60.0
    os.utime(peer.path, (old, old))
    stalls = []

    def slow_reader():
        for i in range(6):
            _time.sleep(0.05)
            yield _batch(i)

    model = LinReg()
    tr = Trainer(model, SGD(model.parameters(), 0.05), _linreg_loss,
                 TrainerConfig(heartbeat=True, heartbeat_dir=hbdir,
                               heartbeat_timeout_s=0.5,
                               heartbeat_interval_s=0.05,
                               on_peer_stall=lambda w, age: stalls.append(
                                   (w, age)),
                               num_ingest_threads=1), device="cpu")
    stats = tr.train(lambda: slow_reader(), num_workers=2, worker_id=0)
    assert stats["steps"] == 6
    assert stalls and stalls[0][0] == 1 and stalls[0][1] > 0.5
    assert tr.stalled_peers == {1}
    assert os.path.exists(os.path.join(hbdir, "worker_0.hb.done"))


def test_heartbeat_off_by_default_single_process():
    from paddle_tpu_torch.static import TrainerConfig
    tr = _port_trainer(TrainerConfig(num_ingest_threads=1))
    assert tr.train(lambda: iter([_batch(0)]))["steps"] == 1
    assert not hasattr(tr, "stalled_peers")


def test_slow_step_anomaly_writes_a_flight_bundle(tmp_path):
    import time as _time
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.observability.watchdog import WatchdogConfig
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    calls = []

    def loss_fn(m, x, y):
        calls.append(1)
        # every step takes at least 50 ms, so host jitter before step 7
        # cannot reach 3x the median, fire slow_step and latch it
        _time.sleep(0.05)
        if len(calls) == 7:
            _time.sleep(0.5)            # one step far above the median
        return _linreg_loss(m, x, y)

    old = flight.configure()
    flight.configure(directory=str(tmp_path / "flight"))
    try:
        model = LinReg()
        tr = Trainer(model, SGD(model.parameters(), 0.05), loss_fn,
                     TrainerConfig(num_ingest_threads=1, max_steps=10,
                                   watchdog=WatchdogConfig(min_samples=4)),
                     device="cpu")
        tr.train(_SeekableDS(20))
    finally:
        flight._SETTINGS.update(old)
    slow = [e for e in tr.watchdog.anomalies
            if e["anomaly"] == "slow_step" and e["wall_s"] >= 0.5]
    assert len(slow) == 1 and slow[0]["step"] == 7
    bundles = flight.list_bundles(str(tmp_path / "flight"))
    assert len(bundles) == len(tr.watchdog.anomalies) >= 1
    assert sorted(flight.read_manifest(b)["reason"] for b in bundles) == \
        sorted(e["anomaly"] for e in tr.watchdog.anomalies)
    for bundle in bundles:
        with open(os.path.join(bundle, "config.json")) as f:
            assert "TrainerConfig(" in json.load(f)["trainer_config"]
