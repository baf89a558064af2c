"""The port's filesystem layer (``paddle_tpu_torch/io/fs.py``), its
checkpoint mirrors and background saves, against the JAX package's.

Each scenario runs through both packages' ``io.fs`` (and, for mirrors,
both ``CheckpointManager``s over a MemFS each) on the same inputs; the
observations (bytes read, listings, committed steps, restored values,
counters, injected faults fired) must be equal. Retries are made fast
and jitter-free in both. Every remote path is unique to its test (the
staging directories are deterministic per path and shared by the
processes of a run).
"""

import os
import shutil
import threading
import uuid

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import flags as JF
from paddle_tpu.io import fs as jfs
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.core import retry as pretry
from paddle_tpu_torch.io import fs as pfs
from paddle_tpu_torch.testing import chaos as pchaos

BOTH = (("jax", jfs, jchaos), ("port", pfs, pchaos))


@pytest.fixture
def fast_retry():
    keys = ("retry_max_attempts", "retry_backoff_base_s",
            "retry_backoff_max_s", "retry_jitter")
    old = {k: JF.get_flag(k) for k in keys}
    JF.set_flags({"retry_max_attempts": 2, "retry_backoff_base_s": 0.001,
                  "retry_backoff_max_s": 0.002, "retry_jitter": 0.0})
    pold = pretry.configure()
    pretry.configure(max_attempts=2, backoff_s=0.001, backoff_max_s=0.002,
                     jitter=0.0)
    yield
    JF.set_flags(old)
    pretry.configure(**pold)


def _scheme(tag):
    return f"{tag}{uuid.uuid4().hex[:8]}"


def _both(scenario, *args):
    """Run ``scenario(fs, chaos, *args)`` through each package and return
    the two observations."""
    return [scenario(fs, ch, *args) for _, fs, ch in BOTH]


# ------------------------------------------------------------------ MemFS

def test_roundtrip_and_listing():
    def run(fs, ch):
        s = _scheme("mem")
        m = fs.MemFS()
        fs.register_filesystem(s, m)
        with fs.fs_open(f"{s}://b/dir/a.bin", "wb") as f:
            f.write(b"\x01\x02")
        with fs.fs_open(f"{s}://b/dir/t.txt", "w") as f:
            f.write("hello")
        obs = [fs.fs_exists(f"{s}://b/dir/a.bin"),
               fs.fs_exists(f"{s}://b/dir"), fs.fs_exists(f"{s}://b/nope"),
               m.isdir(f"{s}://b/dir"), m.isdir(f"{s}://b/dir/a.bin"),
               fs.listdir(f"{s}://b/dir"), fs.listdir(f"{s}://b")]
        with fs.fs_open(f"{s}://b/dir/a.bin", "rb") as f:
            obs.append(f.read())
        with fs.fs_open(f"{s}://b/dir/t.txt", "r") as f:
            obs.append(f.read())
        fs.remove_tree(f"{s}://b/dir")
        obs.append(fs.fs_exists(f"{s}://b/dir/a.bin"))
        return obs
    j, p = _both(run)
    assert j == p == [True, True, False, True, False, ["a.bin", "t.txt"],
                      ["dir"], b"\x01\x02", "hello", False]


def test_unregistered_scheme_errors():
    from paddle_tpu_torch.core.enforce import EnforceError
    with pytest.raises(EnforceError, match="no filesystem registered"):
        pfs.fs_open("gsx://bucket/key")


def test_local_passthrough(tmp_path):
    def run(fs, ch, d):
        p = str(d / "x.txt")
        with fs.fs_open(p, "w") as f:
            f.write("y")
        return fs.fs_exists(p), fs.ensure_local(p) == p
    j, p = _both(run, tmp_path)
    assert j == p == (True, True)


def test_ensure_local_caches(tmp_path):
    def run(fs, ch, d):
        s = _scheme("mem")
        m = fs.MemFS()
        fs.register_filesystem(s, m)
        with fs.fs_open(f"{s}://b/data.bin", "wb") as f:
            f.write(b"abc")
        cache = str(d / f"cache_{s}")
        l1 = fs.ensure_local(f"{s}://b/data.bin", cache_dir=cache)
        first = open(l1, "rb").read()
        m.remove(f"{s}://b/data.bin")       # served from the cache now
        l2 = fs.ensure_local(f"{s}://b/data.bin", cache_dir=cache)
        return first, l2 == l1, open(l2, "rb").read()
    j, p = _both(run, tmp_path)
    assert j == p == (b"abc", True, b"abc")
    pfs.clear_cache()


def test_tree_mirroring(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("A")
    (src / "sub" / "b.txt").write_text("B")

    def run(fs, ch, d):
        s = _scheme("mem")
        fs.register_filesystem(s, fs.MemFS())
        fs.put_tree(str(src), f"{s}://store/ckpt")
        listing = fs.listdir(f"{s}://store/ckpt")
        dst = d / f"dst_{s}"
        fs.get_tree(f"{s}://store/ckpt", str(dst))
        return listing, (dst / "a.txt").read_text(), \
            (dst / "sub" / "b.txt").read_text()
    j, p = _both(run, tmp_path)
    assert j == p == (["a.txt", "sub"], "A", "B")


def test_localfs_listdir_missing_raises_filenotfound(tmp_path):
    from paddle_tpu_torch.io.checkpoint import latest_step
    with pytest.raises(FileNotFoundError):
        pfs.LocalFS().listdir(str(tmp_path / "nope"))
    assert latest_step(str(tmp_path / "nope")) is None
    f = tmp_path / "plainfile"
    f.write_text("x")
    assert latest_step(str(f)) is None


def test_get_tree_failure_leaves_no_partial_tree(tmp_path, fast_retry):
    def run(fs, ch, d):
        s = _scheme("mem")
        m = fs.MemFS()
        with m.open(f"{s}://store/ck/5/a.bin", "wb") as f:
            f.write(b"A")
        with m.open(f"{s}://store/ck/5/b.bin", "wb") as f:
            f.write(b"B")
        plan = ch.FaultPlan().fail("open", path=r"b\.bin$", times=4)
        fs.register_filesystem(s, ch.ChaosFS(m, plan))
        root = d / s
        dst = root / "ck" / "5"
        with pytest.raises(ch.InjectedFault):
            fs.get_tree(f"{s}://store/ck/5", str(dst))
        obs = [dst.exists(), list((root / "ck").glob(".pt_get_tree_*"))]
        plan2 = ch.FaultPlan().fail("open", path=r"b\.bin$")
        fs.register_filesystem(s, ch.ChaosFS(m, plan2))
        fs.get_tree(f"{s}://store/ck/5", str(dst))   # one retry absorbs it
        obs += [(dst / "a.bin").read_bytes(), (dst / "b.bin").read_bytes(),
                plan2.fired("open")]
        return obs
    j, p = _both(run, tmp_path)
    assert j == p == [False, [], b"A", b"B", 1]


def test_remote_open_retries_transients():
    old = pretry.configure()
    JF_old = {k: JF.get_flag(k) for k in ("retry_max_attempts",
                                          "retry_backoff_base_s")}
    JF.set_flags({"retry_max_attempts": 3, "retry_backoff_base_s": 0.001})
    pretry.configure(max_attempts=3, backoff_s=0.001)

    def run(fs, ch):
        s = _scheme("flaky")
        m = fs.MemFS()
        with m.open(f"{s}://b/x", "wb") as f:
            f.write(b"1")
        plan = ch.FaultPlan().fail("open", times=2)
        fs.register_filesystem(s, ch.ChaosFS(m, plan))
        with fs.fs_open(f"{s}://b/x", "rb") as f:
            data = f.read()
        return data, plan.fired("open")
    try:
        j, p = _both(run)
    finally:
        JF.set_flags(JF_old)
        pretry.configure(**old)
    assert j == p == (b"1", 2)


def test_reads_remote_files(tmp_path):
    """The reference's FileDataset test reads record files through the
    scheme layer; the port has no FileDataset, so the same staging path
    (``ensure_local``) feeds a numpy reader of the same records."""
    rs = np.random.RandomState(0)
    recs = rs.rand(5, 3).astype(np.float32)
    local = tmp_path / "part0.npy"
    np.save(local, recs)

    def run(fs, ch, d):
        s = _scheme("mem")
        fs.register_filesystem(s, fs.MemFS())
        with open(local, "rb") as f, fs.fs_open(f"{s}://data/part0.npy",
                                                "wb") as out:
            shutil.copyfileobj(f, out)
        return np.load(fs.ensure_local(f"{s}://data/part0.npy",
                                       cache_dir=str(d / s)))
    j, p = _both(run, tmp_path)
    np.testing.assert_array_equal(j, recs)
    np.testing.assert_array_equal(p, recs)


# -------------------------------------------------------------- mirrors

def _jstate(v):
    return {"w": jnp.arange(4.0) + v, "step": jnp.asarray(int(v), jnp.int32)}


def _pstate(v):
    return {"w": torch.arange(4.0) + v,
            "step": torch.tensor(int(v), dtype=torch.int32)}


def _staging(url, port):
    import hashlib
    import tempfile
    tag = hashlib.sha1(url.rstrip("/").encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), "pt_torch_ckpt_staging"
                        if port else "pt_ckpt_staging", tag)


def _managers():
    from paddle_tpu.io.checkpoint import CheckpointManager as J
    from paddle_tpu_torch.io.checkpoint import CheckpointManager as P
    return (("jax", J, jfs, _jstate), ("port", P, pfs, _pstate))


def _w(state):
    return np.asarray(state["w"]).tolist()


def test_save_mirror_restore_fresh_host():
    out = []
    for name, Mgr, fs, make in _managers():
        s = _scheme("mem")
        fs.register_filesystem(s, fs.MemFS())
        url = f"{s}://bucket/ck_test"
        with Mgr(url, max_to_keep=2) as mgr:
            for v in (1, 2, 3):
                assert mgr.save(v, make(v))
        remote = sorted(n for n in fs.listdir(url) if n.isdigit())
        shutil.rmtree(_staging(url, name == "port"), ignore_errors=True)
        with Mgr(url, max_to_keep=2) as mgr2:        # a fresh host
            restored, step = mgr2.restore(make(0))
        shutil.rmtree(_staging(url, name == "port"), ignore_errors=True)
        out.append((remote, step, _w(restored)))
    assert out[0] == out[1] == (["2", "3"], 3, [3.0, 4.0, 5.0, 6.0])


def test_local_paths_unchanged(tmp_path):
    out = []
    for name, Mgr, _, make in _managers():
        with Mgr(str(tmp_path / name)) as mgr:
            mgr.save(1, make(1))
            restored, step = mgr.restore(make(0))
        out.append((step, _w(restored)))
    assert out[0] == out[1] == (1, [1.0, 2.0, 3.0, 4.0])


def test_fresh_host_save_preserves_remote_history():
    out = []
    for name, Mgr, fs, make in _managers():
        s = _scheme("mem")
        fs.register_filesystem(s, fs.MemFS())
        url = f"{s}://bucket/ck_hist"
        stage = _staging(url, name == "port")
        with Mgr(url, max_to_keep=3) as mgr:
            for v in (1, 2):
                mgr.save(v, make(v))
        shutil.rmtree(stage, ignore_errors=True)
        with Mgr(url, max_to_keep=3) as mgr2:
            _, step = mgr2.restore(make(0))
            mgr2.save(3, make(3))
        first = sorted(n for n in fs.listdir(url) if n.isdigit())
        shutil.rmtree(stage, ignore_errors=True)
        with Mgr(url, max_to_keep=3) as mgr3:
            mgr3.restore(make(0))
            mgr3.save(4, make(4))
        second = sorted(int(n) for n in fs.listdir(url) if n.isdigit())
        shutil.rmtree(stage, ignore_errors=True)
        out.append((step, first, second))
    assert out[0] == out[1] == (2, ["1", "2", "3"], [2, 3, 4])


def _chaos_mirror(ch, fs):
    s = _scheme("chaos")
    plan = ch.FaultPlan()
    mem = fs.MemFS()
    fs.register_filesystem(s, ch.ChaosFS(mem, plan))
    return s, plan, mem


def test_training_survives_and_mirror_recovers(fast_retry):
    """A mirror push of step 2 fails twice (both retries of its first
    object): the save degrades, training goes on, the next save
    re-pushes it, and a fresh host restores the newest committed step."""
    from paddle_tpu.static.trainer import Trainer as JTrainer
    from paddle_tpu.static.trainer import TrainerConfig as JConfig
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    from paddle_tpu.io.checkpoint import CheckpointManager as JM
    from paddle_tpu_torch.io.checkpoint import CheckpointManager as PM

    def reader():
        for _ in range(100):
            yield (np.ones((1,), np.float32),)

    out = []
    for name, fs, ch in BOTH:
        s, plan, _ = _chaos_mirror(ch, fs)
        url = f"{s}://bucket/ck_degrade"
        shutil.rmtree(_staging(url, name == "port"), ignore_errors=True)
        plan.fail("write", path=r"/2/", times=2)
        kw = dict(num_ingest_threads=1, max_steps=6, checkpoint_dir=url,
                  checkpoint_every=2, prefetch=False)
        if name == "jax":
            def step(state, x):
                return jnp.sum(x), {"w": state["w"] + 1.0}
            state, stats = JTrainer(step, JConfig(**kw)).train(
                {"w": jnp.zeros(())}, lambda: reader())
            w = float(state["w"])
        else:
            model = torch.nn.Module()
            model.w = torch.nn.Parameter(torch.zeros(()))

            def loss_fn(m, x):      # d loss / d w = -1: SGD(1) adds 1
                return -m.w * x.sum()
            tr = Trainer(model, SGD(model.parameters(), 1.0), loss_fn,
                         TrainerConfig(**kw), device="cpu")
            stats = tr.train(lambda: reader())
            w = float(model.w)
        committed = sorted(n for n in fs.listdir(url) if n.isdigit()
                           and fs.fs_exists(f"{url}/{n}/COMMIT"))
        shutil.rmtree(_staging(url, name == "port"), ignore_errors=True)
        if name == "jax":
            with JM(url) as mgr:
                restored, at = mgr.restore({"w": jnp.zeros(())})
            rw = float(restored["w"])
        else:
            with PM(url) as mgr:
                template = {"params": {"w": torch.zeros(())},
                            "opt": tr.optimizer.state_tree(
                                dict(model.named_parameters())),
                            "buffers": {}}
                restored, at = mgr.restore(template)
            rw = float(restored["params"]["w"])
        shutil.rmtree(_staging(url, name == "port"), ignore_errors=True)
        out.append((stats["steps"], w, plan.fired("write"), committed, at,
                    rw))
    assert out[0] == out[1] == (6, 6.0, 2, ["2", "4", "6"], 6, 6.0)


def test_strict_mirror_raises_into_caller(fast_retry):
    from paddle_tpu.io.checkpoint import CheckpointManager as JM
    from paddle_tpu_torch.io.checkpoint import CheckpointManager as PM
    s, plan, _ = _chaos_mirror(jchaos, jfs)
    plan.fail("write", times=2)
    with JM(f"{s}://bucket/ck_strict", strict_mirror=True) as mgr:
        with pytest.raises(jchaos.InjectedFault):
            mgr.save(1, {"w": jnp.ones(())})
    s, plan, _ = _chaos_mirror(pchaos, pfs)
    plan.fail("write", times=2)
    mgr = PM(f"{s}://bucket/ck_strict", strict_mirror=True)
    mgr.save(1, {"w": torch.ones(())})    # the push runs behind
    with pytest.raises(pchaos.InjectedFault):
        mgr.wait()                        # its failure raises here
    assert mgr._mirror_pending == [1]
    mgr.close()                           # a last, best-effort push
    assert mgr._thread is None and mgr._mirror_pending == []
    assert pfs.fs_exists(f"{s}://bucket/ck_strict/1/COMMIT")


def test_restore_skips_uncommitted_torn_step():
    out = []
    for name, Mgr, fs, make in _managers():
        ch = jchaos if name == "jax" else pchaos
        s, plan, mem = _chaos_mirror(ch, fs)
        url = f"{s}://bucket/ck_torn"
        stage = _staging(url, name == "port")
        with Mgr(url) as mgr:
            for v in (1, 2, 3):
                assert mgr.save(v, make(v))
        mem.remove(f"{url}/3/COMMIT")       # a crash mid-mirror of 3
        with fs.fs_open(f"{url}/9/fragment", "wb") as f:
            f.write(b"partial")
        shutil.rmtree(stage, ignore_errors=True)
        with Mgr(url) as mgr2:
            restored, at = mgr2.restore(make(0))
        shutil.rmtree(stage, ignore_errors=True)
        with Mgr(url) as mgr3:
            with pytest.raises(Exception, match="no COMMIT"):
                mgr3.restore(make(0), step=3)
        shutil.rmtree(stage, ignore_errors=True)
        out.append((at, _w(restored)))
    assert out[0] == out[1] == (2, [2.0, 3.0, 4.0, 5.0])


# ------------------------------------------------------ background saves

class _HeldWriter:
    """Holds every background write until :meth:`release`."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.io import checkpoint as C
        self.gate = threading.Event()
        self.entered = threading.Event()
        orig = C.save_persistables

        def held(*a, **kw):
            self.entered.set()
            assert self.gate.wait(30)
            return orig(*a, **kw)
        monkeypatch.setattr(C, "save_persistables", held)

    def release(self):
        self.gate.set()


def test_save_returns_before_the_write_lands(tmp_path, monkeypatch):
    from paddle_tpu_torch.io import CheckpointManager
    held = _HeldWriter(monkeypatch)
    w = torch.arange(6.0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(1, {"w": w})
    assert held.entered.wait(10)           # the writer took the job ...
    assert mgr.steps() == []               # ... and nothing has landed
    w.add_(100.0)                          # the next step writes in place
    held.release()
    mgr.wait()
    assert mgr.steps() == [1]
    restored, _ = mgr.restore({"w": torch.zeros(6)})
    assert torch.equal(restored["w"], torch.arange(6.0))   # pre-write bytes
    writer = mgr._thread
    mgr.close()
    assert mgr._thread is None and not writer.is_alive()


def test_restore_waits_for_queued_saves(tmp_path, monkeypatch):
    from paddle_tpu_torch.io import CheckpointManager
    held = _HeldWriter(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": torch.ones(3)})
    mgr.save(2, {"w": torch.full((3,), 2.0)})
    threading.Timer(0.2, held.release).start()
    restored, at = mgr.restore({"w": torch.zeros(3)})   # waits first
    assert at == 2 and float(restored["w"][0]) == 2.0
    mgr.close()


def test_synchronous_saves_write_inside_save(tmp_path):
    from paddle_tpu_torch.io import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"), background=False)
    mgr.save(1, {"w": torch.ones(3)}, version="v7")
    assert mgr.steps() == [1] and mgr._thread is None
    assert mgr.read_meta(1) == {"model_version": "v7"}


def test_preemption_waits_for_its_save(tmp_path, monkeypatch):
    import signal
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.io import checkpoint as C
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import Preempted, Trainer, TrainerConfig
    orig = C.save_persistables

    def slow(*a, **kw):
        import time
        time.sleep(0.3)
        return orig(*a, **kw)
    monkeypatch.setattr(C, "save_persistables", slow)
    calls = []

    def loss_fn(m, x):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return (m.w * x).sum()

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.ones(()))

    def reader():
        for _ in range(20):
            yield (np.ones((2,), np.float32),)
    tr = Trainer(model, SGD(model.parameters(), 0.1), loss_fn,
                 TrainerConfig(num_ingest_threads=1, max_steps=10,
                               checkpoint_dir=str(tmp_path / "ck"),
                               checkpoint_every=100, handle_preemption=True),
                 device="cpu")
    with pytest.raises(Preempted) as info:
        tr.train(lambda: reader())
    assert info.value.step == 3
    # the forced save is on disk when Preempted is raised
    assert CheckpointManager(str(tmp_path / "ck")).steps() == [3]
