"""Local multi-process launcher, runtime init and the file all-gather
(ref: ``paddle_tpu/parallel/launch.py``).

``host_allgather`` exchanges host numpy arrays between local processes
through a shared directory: each rank publishes its array atomically (a
temporary file, then ``os.replace``) and waits for the others' files
under a :class:`~paddle_tpu_torch.core.retry.RetryPolicy`. The payloads
are ``.npy`` files named as the reference names them, so a port process
and a JAX-package process can exchange through one directory byte for
byte. The fleet router's subprocess replicas ride on it
(``serving/fleet.py``).

``init_distributed`` reads the reference's ``PT_COORDINATOR``,
``PT_NUM_PROCESSES`` and ``PT_PROCESS_ID`` and joins a
``torch.distributed`` group: gloo when the caller asks for the CPU, nccl
otherwise.

Usage:
  python -m paddle_tpu_torch.parallel.launch --nproc 4 train.py
"""

import argparse
import os
import re
import subprocess
import sys

import numpy as np

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core import retry as _retry
from paddle_tpu_torch.core.retry import RetryPolicy


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device="cuda"):
    """Join the process group named by the arguments or the ``PT_*``
    environment (``coordinator_address`` is ``host:port``); returns False
    without touching ``torch.distributed`` when no coordinator is set (a
    single process). ``device="cpu"`` takes the gloo backend, a card the
    nccl one."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("PT_COORDINATOR")
    if coordinator_address is None:
        return False  # single process
    import torch.distributed as dist
    backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or env.get("PT_NUM_PROCESSES", 1)),
        rank=int(process_id or env.get("PT_PROCESS_ID", 0)))
    return True


def _gather_retryable(exc):
    """host_allgather's wait-for-peer predicate: an absent file is the
    normal not-published-yet state here (unlike remote I/O, where
    core/retry.py treats FileNotFoundError as an answer), and
    ValueError/EOFError are a peer's np.save caught mid-os.replace."""
    return isinstance(exc, (FileNotFoundError, ValueError, EOFError,
                            OSError))


def host_allgather(arr, rank, world, exchange_dir, tag, timeout=60.0,
                   generation=None, policy=None, ragged=False):
    """All-gather host numpy arrays across local processes through the
    shared directory ``exchange_dir``. Each rank publishes its array
    atomically, then waits for the others under a RetryPolicy (backoff
    5 ms rising x1.5 to 50 ms, jittered by core/retry.py's ``jitter``
    setting, overall deadline ``timeout``; pass ``policy`` to
    override). ``tag`` must be unique per collective call
    site. Returns ``[world, *arr.shape]``, or with ``ragged=True`` a list
    of the ``world`` per-rank arrays (message-style exchanges, such as
    the fleet router's JSON command/response wire, whose payloads differ
    in length). A rank that does not publish in time raises
    TimeoutError.

    ``generation`` isolates incarnations of the same tag (a respawned
    subprocess replica restarts its command sequence at 0): files are
    published as ``{tag}.g{generation}_{rank}.npy`` and every file of
    this tag from an older generation is removed first, so a respawned
    rank never reads a dead peer's stale payload as fresh."""
    os.makedirs(exchange_dir, exist_ok=True)
    arr = np.asarray(arr)
    base = tag if generation is None else f"{tag}.g{int(generation)}"
    if generation is not None:
        stale = re.compile(rf"^{re.escape(tag)}\.g(\d+)_\d+\.npy$")
        for name in os.listdir(exchange_dir):
            m = stale.match(name)
            if m and int(m.group(1)) < int(generation):
                try:
                    os.remove(os.path.join(exchange_dir, name))
                except OSError:
                    pass           # the other rank's cleanup won the race
    tmp = os.path.join(exchange_dir, f".{base}_{rank}.tmp.npy")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, os.path.join(exchange_dir, f"{base}_{rank}.npy"))
    pol = policy or RetryPolicy(
        max_attempts=1_000_000_000, backoff_s=0.005, backoff_max_s=0.05,
        multiplier=1.5, jitter=_retry.configure()["jitter"],
        deadline_s=timeout, retryable=_gather_retryable)
    out = []
    for r in range(world):
        path = os.path.join(exchange_dir, f"{base}_{r}.npy")

        def load_peer(p=path):
            return np.load(p)

        try:
            out.append(pol.call(load_peer))
        except Exception as e:
            if not _gather_retryable(e):
                raise
            raise TimeoutError(
                f"host_allgather({tag}): rank {r} did not publish "
                f"within {timeout}s") from e
    return out if ragged else np.stack(out)


def launch_local(nproc, script, script_args=(), base_port=12355,
                 env_extra=None):
    """Start ``nproc`` local processes of ``script``, each with the
    ``PT_COORDINATOR`` / ``PT_NUM_PROCESSES`` / ``PT_PROCESS_ID``
    environment that :func:`init_distributed` reads."""
    procs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update({
            "PT_COORDINATOR": f"127.0.0.1:{base_port}",
            "PT_NUM_PROCESSES": str(nproc),
            "PT_PROCESS_ID": str(rank),
        })
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, script, *script_args], env=env))
    return procs


def wait_all(procs, timeout=600):
    """Wait for every rank; kill the ones still running and raise if any
    failed."""
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(c != 0 for c in codes):
        raise RuntimeError(f"distributed job failed, exit codes: {codes}")
    return codes


def main():
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch local distributed launcher")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--port", type=int, default=12355)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    procs = launch_local(args.nproc, args.script, args.script_args, args.port)
    wait_all(procs)


if __name__ == "__main__":
    main()
