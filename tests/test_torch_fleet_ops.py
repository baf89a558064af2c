"""The fleet router's live operations, the port's against the JAX
package's with the harness of test_torch_fleet.py (same seeded weights,
prompts and settable clocks; statuses, greedy tokens, finishing replicas,
failovers, the ``fleet.*`` counters, states, versions, ``version_stats``
and the ``ops_log`` kinds held equal): a rolling deploy to ``v1`` with
requests in flight, a checkpoint deploy whose second step's crc32
manifest is corrupt (``DeployAborted``, the fleet serving on), a canary
whose goodput falls below the baseline's by more than the margin and
rolls back, and the autoscaler spawning under backlog and draining back
to its floor. Weights for ``v1`` are the JAX tree of another seed, bridged
into a port decoder."""

import json
import os

import pytest

from tests.test_torch_fleet import (alone, compare, fast_retry,  # noqa
                                    pair, prompts_of)


def deploy(side):
    """In-flight work drains on v0 while the swap rolls through; fresh
    traffic then decodes on v1."""
    r = side.router
    fids = [r.submit(p, max_new=6) for p in prompts_of(4, seed=31)]
    r.step()
    assert r.deploy(side.weights(1), version="v1") == "v1"
    fids += [r.submit(p, max_new=8) for p in prompts_of(2, seed=32)]
    r.drain()
    return fids


def checkpoint_deploy(side, ck):
    """Steps 1 ("good") and 2 ("bad", one crc32 flipped) of v1's weights:
    step 1 deploys under its manifest's tag, step 2 aborts before any
    replica is touched, and the fleet serves on."""
    r = side.router
    if side.name == "jax":
        with side.checkpoint.CheckpointManager(ck) as mgr:
            mgr.save(1, side.weights(1), force=True, version="good")
            mgr.save(2, side.weights(1), force=True, version="bad")
    else:
        state = {"params": dict(side.weights(1).named_parameters())}
        with side.checkpoint.CheckpointManager(ck) as mgr:
            mgr.save(1, state, force=True, version="good")
            mgr.save(2, state, force=True, version="bad")
    meta_path = os.path.join(ck, "2.meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["crc32"][sorted(meta["crc32"])[0]]["crc32"] ^= 0xDEADBEEF
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    fids = [r.submit(p, max_new=5) for p in prompts_of(3, seed=33)]
    assert r.deploy(ck, step=1) == "good"
    with pytest.raises(side.DeployAborted):
        r.deploy(ck, step=2)
    assert r._versions == ["good", "good"] and not r._pending_swaps
    fids += [r.submit(p, max_new=5) for p in prompts_of(2, seed=34)]
    r.drain()
    return fids


def canary(side):
    """Weight 1.0 sends fresh traffic to the canary; a forged SLO gap
    (canary 0 %, baseline 100 %) aborts it and rolls the replica back."""
    r = side.router
    assert r.deploy(side.weights(1), version="v1", canary=True) == "v1"
    fids = [r.submit(p, max_new=4) for p in prompts_of(2, seed=35)]
    while any(r.requests[f].status != "done" for f in fids):
        r.step()
    with r._lock:
        r._version_stats = {"v0": [10, 10], "v1": [10, 0]}
    r.step()
    for _ in range(100):
        if r._versions == ["v0", "v0"]:
            break
        r.step()
    fids += [r.submit(p, max_new=4) for p in prompts_of(2, seed=36)]
    r.drain()
    return fids


def autoscale(side):
    r = side.router
    fids = [r.submit(p, max_new=4) for p in prompts_of(12, seed=37)]
    for _ in range(300):
        r.step()
        if all(r.requests[f].status == "done" for f in fids):
            break
    for _ in range(300):
        if sum(1 for s in r._states if s == "live") == 1:
            break
        r.step()
    return fids


def test_rolling_deploy_matches_jax(fast_retry):
    side, s = compare(deploy, dict(num_replicas=2))
    assert s["versions"] == ["v1", "v1"] and s["baseline"] == "v1"
    assert s["ops"].count("swap") == 2
    assert [q[4] for q in s["requests"]] == ["v0"] * 4 + ["v1"] * 2
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from tests.test_torch_fleet import SERVE
    eng = ServingEngine(pair(1)[2], ServeConfig(**SERVE))
    rids = [eng.submit(p, max_new=8) for p in prompts_of(2, seed=32)]
    eng.drain()
    assert [q[2] for q in s["requests"][4:]] == [
        eng.requests[r].tokens for r in rids]
    assert [q[2] for q in s["requests"][:4]] == alone(
        prompts_of(4, seed=31), 6)


def test_corrupt_manifest_aborts_and_the_fleet_serves_on(fast_retry,
                                                         tmp_path):
    dirs = iter([str(tmp_path / "jax"), str(tmp_path / "port")])
    side, s = compare(lambda side: checkpoint_deploy(side, next(dirs)),
                      dict(num_replicas=2))
    assert s["ops"][-1] == "deploy_abort"
    assert s["counters"]["fleet.deploys"] == {"status=ok": 1,
                                              "status=aborted": 1}
    assert all(q[0] == "done" for q in s["requests"])


def test_canary_abort_matches_jax(fast_retry):
    side, s = compare(canary, dict(num_replicas=2, canary_weight=1.0,
                                   canary_min_retired=2,
                                   canary_margin=0.05))
    assert s["counters"]["fleet.canary_aborts"] == {"": 1}
    assert s["versions"] == ["v0", "v0"] and s["canary"] is None
    assert [q[4] for q in s["requests"]] == ["v1", "v1", "v0", "v0"]
    assert "canary_abort" in s["ops"]


def test_autoscale_up_and_down_matches_jax(fast_retry):
    side, s = compare(autoscale, dict(num_replicas=1, autoscale_min=1,
                                      autoscale_max=3,
                                      scale_cooldown_s=0.0))
    assert "scale_up" in s["ops"] and "scale_down" in s["ops"]
    assert s["states"].count("live") == 1 and "retired" in s["states"]
    assert [q[2] for q in s["requests"]] == alone(prompts_of(12, seed=37),
                                                  4)
