"""Run a function of the port on N ranks of a ``torch.distributed`` group.

    from lbfgspp_tpu_torch.tools import spawn_ranks
    per_rank = spawn_ranks.run("lbfgspp_tpu_torch.tools.sharded_cases:"
                               "collectives", world=2, timeout=120)

Each rank is a fresh ``python -m lbfgspp_tpu_torch.tools.spawn_ranks``
process (no state of the caller, JAX included, reaches it) that joins one
group through a rendezvous file in a temporary directory, calls
``module:function(*args, **kwargs)`` and sends its result back pickled,
tensors as numpy arrays.  ``run`` returns the ranks' results in rank
order.  A rank that fails, or a run that outlasts ``timeout`` seconds (a
rank waiting in a collective that another never reaches), kills every
rank and raises, so a hang fails one caller instead of stalling it.

``backend``: ``"gloo"`` (CPU or CUDA tensors) or ``"nccl"`` (one card
per rank).  Nothing is opened beyond the local host's loopback.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def to_numpy(tree):
    """``tree`` with every tensor as a numpy array (bfloat16 widened to
    float32); tuples, NamedTuples, lists and dicts are walked."""
    import torch
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def run(target: str, world: int = 2, args=(), kwargs=None,
        backend: str = "gloo", timeout: float = 300.0) -> list:
    """The results of ``target`` ("module:function") on each of ``world``
    ranks, in rank order."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        with open(os.path.join(tmp, "task.pkl"), "wb") as f:
            pickle.dump((target, tuple(args), dict(kwargs or {})), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        # every rank is on this host: gloo's pairs connect over loopback,
        # not over whatever address the host name resolves to
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs = []
        for rank in range(world):
            log = open(os.path.join(tmp, f"log{rank}.txt"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "lbfgspp_tpu_torch.tools.spawn_ranks",
                 tmp, str(rank), str(world), backend, str(timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp), log))
        deadline = time.monotonic() + timeout
        try:
            for p, _ in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                f"{target} on {world} ranks did not finish in {timeout} s:"
                f"\n{_tails(tmp, world)}") from None
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{target}: rank(s) {bad} failed:\n"
                               f"{_tails(tmp, world)}")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _tails(tmp: str, world: int, size: int = 4000) -> str:
    parts = []
    for rank in range(world):
        path = os.path.join(tmp, f"log{rank}.txt")
        with open(path, "rb") as f:
            text = f.read().decode(errors="replace")
        parts.append(f"--- rank {rank}:\n{text[-size:]}")
    return "\n".join(parts)


def _child(tmp: str, rank: int, world: int, backend: str,
           timeout: float) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "task.pkl"), "rb") as f:
        target, args, kwargs = pickle.load(f)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(
            *args, **kwargs)
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(to_numpy(result), f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           float(sys.argv[5]))
