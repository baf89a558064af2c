"""The port's file all-gather (``paddle_tpu_torch/parallel/launch.py``)
against the JAX package's: the reference's five ``host_allgather`` cases
(a delayed writer, ragged payloads through ``_pack``/``_unpack``, a
timeout, stale-generation cleanup, generation isolation) run on the
port, and a port rank and a JAX rank exchange through one directory, each
reading the other's payload bit for bit, so the two packages share one
wire. ``init_distributed`` without a coordinator is a single process in
both."""

import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.parallel import launch as jlaunch
from paddle_tpu_torch.parallel import launch


def _publish_raw(xdir, tag, arr):
    """Drop an exchange file the way a (now dead) peer would have."""
    tmp = os.path.join(xdir, "_t.npy")
    np.save(tmp, arr)
    os.replace(tmp, os.path.join(xdir, tag + ".npy"))


def _in_thread(fn):
    out = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as e:      # re-raised by the joiner
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, out


def _join(t, out):
    t.join(timeout=30)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out.get("value")


def test_delayed_writer(tmp_path):
    """The gather waits out a slow peer under the RetryPolicy."""
    xdir = str(tmp_path)
    mine = np.arange(4, dtype=np.int32)
    theirs = np.arange(4, 8, dtype=np.int32)

    def late_publish():
        time.sleep(0.25)
        return launch.host_allgather(theirs, 1, 2, xdir, "slow",
                                     timeout=5.0)

    t, res = _in_thread(late_publish)
    out = launch.host_allgather(mine, 0, 2, xdir, "slow", timeout=5.0)
    peer = _join(t, res)
    assert np.array_equal(out, np.stack([mine, theirs]))
    assert np.array_equal(peer, out)


def test_ragged_gather_returns_per_rank_payloads(tmp_path):
    """ragged=True carries payloads of different lengths (the fleet's
    JSON wire); without it the same exchange raises."""
    from paddle_tpu_torch.serving.fleet import _pack, _unpack
    xdir = str(tmp_path)
    cmd = _pack({"op": "round", "submit": [{"key": 0}]})
    ack = _pack({})
    assert cmd.shape != ack.shape
    t, res = _in_thread(lambda: launch.host_allgather(
        ack, 1, 2, xdir, "rg", timeout=5.0, ragged=True))
    out = launch.host_allgather(cmd, 0, 2, xdir, "rg", timeout=5.0,
                                ragged=True)
    _join(t, res)
    assert isinstance(out, list) and len(out) == 2
    assert _unpack(out[0]) == {"op": "round", "submit": [{"key": 0}]}
    assert _unpack(out[1]) == {}
    _publish_raw(xdir, "rg2_1", ack)
    with pytest.raises(ValueError, match="same shape"):
        launch.host_allgather(cmd, 0, 2, xdir, "rg2", timeout=5.0)


def test_timeout_still_raises_timeout_error(tmp_path):
    with pytest.raises(TimeoutError, match="rank 1 did not publish"):
        launch.host_allgather(np.zeros(2, np.int32), 0, 2, str(tmp_path),
                              "alone", timeout=0.2)


def test_stale_file_collision_cleaned_by_generation(tmp_path):
    """A dead incarnation's payloads under the same tag are neither read
    as fresh nor left on disk."""
    xdir = str(tmp_path)
    stale = np.full(3, 99, np.int32)
    fresh = np.arange(3, dtype=np.int32)
    _publish_raw(xdir, "c0.g0_0", stale)
    _publish_raw(xdir, "c0.g0_1", stale)
    t, res = _in_thread(lambda: launch.host_allgather(
        fresh + 10, 1, 2, xdir, "c0", timeout=5.0, generation=1))
    out = launch.host_allgather(fresh, 0, 2, xdir, "c0", timeout=5.0,
                                generation=1)
    _join(t, res)
    assert np.array_equal(out[0], fresh)
    assert np.array_equal(out[1], fresh + 10)
    left = sorted(f for f in os.listdir(xdir) if ".g0_" in f)
    assert left == [], f"stale generation-0 files survived: {left}"


def test_generation_isolation_times_out_instead_of_stale_read(tmp_path):
    xdir = str(tmp_path)
    _publish_raw(xdir, "x0.g0_1", np.full(3, 99, np.int32))
    with pytest.raises(TimeoutError):
        launch.host_allgather(np.zeros(3, np.int32), 0, 2, xdir, "x0",
                              timeout=0.2, generation=1)


@pytest.mark.parametrize("port_rank", [0, 1])
@pytest.mark.parametrize("ragged", [False, True])
def test_port_and_jax_ranks_share_one_wire(tmp_path, port_rank, ragged):
    """A port rank and a JAX rank gather through one directory, in
    threads: each reads the other's payload bit for bit (float32 with
    NaN and signed-zero bit patterns, and the fleet's JSON wire),
    under a generation, and the files each publishes are the same
    bytes."""
    from paddle_tpu.serving.fleet import _pack as jpack
    from paddle_tpu.serving.fleet import _unpack as junpack
    from paddle_tpu_torch.serving.fleet import _pack, _unpack
    xdir = str(tmp_path / "x")
    rs = np.random.RandomState(7)
    if ragged:
        msg = {"op": "round", "submit": [{"key": 3, "prompt": [1, 2, 3],
                                          "deadline_in_s": 0.25}]}
        payloads = [_pack(msg), jpack({"submitted": [], "queued": 1})]
        assert np.array_equal(payloads[0], jpack(msg))
    else:
        f = rs.standard_normal(6).astype(np.float32)
        f.view(np.uint32)[:2] = [0x7FC00001, 0x80000000]   # NaN, -0.0
        payloads = [f, rs.standard_normal(6).astype(np.float32)]
    ranks = {port_rank: launch, 1 - port_rank: jlaunch}

    def gather(rank):
        return ranks[rank].host_allgather(
            payloads[rank], rank, 2, xdir, "mix", timeout=10.0,
            generation=2, ragged=ragged)

    t, res = _in_thread(lambda: gather(1))
    got0 = gather(0)
    got1 = _join(t, res)
    for got in (got0, got1):
        for r in range(2):
            assert got[r].dtype == payloads[r].dtype
            assert got[r].tobytes() == payloads[r].tobytes()
    if ragged:
        assert _unpack(got0[1]) == junpack(got1[1])
        assert junpack(got1[0]) == _unpack(got0[0])
    # the port writes the JAX package's file bytes
    for r in range(2):
        with open(os.path.join(xdir, f"mix.g2_{r}.npy"), "rb") as fh:
            want = fh.read()
        redo = str(tmp_path / f"redo{r}")
        os.makedirs(redo)
        launch.host_allgather(payloads[r], 0, 1, redo, "mix", timeout=1.0,
                              generation=2)
        with open(os.path.join(redo, "mix.g2_0.npy"), "rb") as fh:
            assert fh.read() == want


def test_init_distributed_is_a_single_process_without_a_coordinator(
        monkeypatch):
    monkeypatch.delenv("PT_COORDINATOR", raising=False)
    assert launch.init_distributed(device="cpu") is False
    assert jlaunch.init_distributed() is False


def test_launch_local_sets_the_reference_environment(tmp_path):
    """Two ranks of a script started by ``launch_local`` see the
    ``PT_*`` variables the JAX launcher sets, and ``wait_all`` returns
    their exit codes."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys\n"
        "with open(os.path.join(sys.argv[1], os.environ['PT_PROCESS_ID']),"
        " 'w') as f:\n"
        "    f.write(os.environ['PT_COORDINATOR'] + ' '"
        " + os.environ['PT_NUM_PROCESSES'])\n")
    procs = launch.launch_local(2, str(script), [str(tmp_path)],
                                base_port=12999)
    assert launch.wait_all(procs, timeout=60) == [0, 0]
    for rank in ("0", "1"):
        assert (tmp_path / rank).read_text() == "127.0.0.1:12999 2"
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(RuntimeError, match="exit codes"):
        launch.wait_all(launch.launch_local(1, str(bad)), timeout=60)


def test_default_policy_is_the_references(tmp_path, monkeypatch):
    """Without ``policy`` the wait's schedule is the reference's: backoff
    5 ms rising x1.5 to 50 ms, jittered by the retry settings' jitter,
    which is the reference's ``retry_jitter`` flag."""
    from paddle_tpu.core.flags import get_flag
    from paddle_tpu.core.retry import RetryPolicy as JPolicy
    made = []

    class Recording(launch.RetryPolicy):
        def __init__(self, **kw):
            made.append(kw)
            super().__init__(**kw)

    monkeypatch.setattr(launch, "RetryPolicy", Recording)
    launch.host_allgather(np.zeros(2), 0, 1, str(tmp_path), "t")
    pol = launch.RetryPolicy(**made[0])
    ref = JPolicy(max_attempts=1, backoff_base_s=0.005, backoff_max_s=0.05,
                  backoff_multiplier=1.5)
    assert pol.jitter == ref.jitter == get_flag("retry_jitter") == 0.25
    assert (pol.backoff_s, pol.backoff_max_s, pol.multiplier) == (
        0.005, 0.05, 1.5)
