"""Start a function on the ranks of a job, one process a rank.

``torchrun`` is the usual launcher; this module is the small one the port
uses where a program starts its own ranks (the daemon's follower ranks, the
tests' gloo jobs on the CPU, two ranks sharing one card):

    results = run_ranks("path/to/file.py:fn", world=2, kwargs={...}, timeout_s=120)

runs ``fn(rank=r, world=2, coordinator="127.0.0.1:PORT", **kwargs)`` in
``world`` fresh Python processes (``python -m
whisper_mlx_tpu_torch.parallel.launch``), each of which joins the job
itself (``parallel/mesh.py:init_distributed``), and returns each rank's
return value in rank order. The rendezvous port is a free one the kernel
hands out (a socket bound to port 0). Every process is killed when the call
ends, by success, failure or its time limit; a rank that fails or is still
running at the limit raises ``RuntimeError`` with the tail of its output.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now (bound to 0, then closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict[str, str] | None) -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(extra or {})
    return env


def start(argv: list[str], log: Path, env: dict[str, str] | None = None) -> subprocess.Popen:
    """One process of the repo's Python with ``argv``, its output in ``log``."""
    with open(log, "wb") as out:
        return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=_env(env),
                                stdout=out, stderr=subprocess.STDOUT)


def stop(procs: list[subprocess.Popen], grace_s: float = 10.0) -> None:
    """Wait up to ``grace_s`` for ``procs`` to end, then kill the rest."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_bytes()[-n:].decode(errors="replace")
    except OSError:
        return ""


def run_ranks(target: str, world: int, kwargs: dict | None = None, timeout_s: float = 300.0,
              env: dict[str, str] | None = None) -> list[Any]:
    """``target`` (``"file.py:function"``) on ``world`` ranks; -> the ranks'
    return values in rank order (module docstring)."""
    coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        tmp = Path(tmp)
        (tmp / "kwargs.pkl").write_bytes(pickle.dumps(kwargs or {}))
        procs, logs = [], []
        try:
            for r in range(world):
                logs.append(tmp / f"rank{r}.log")
                procs.append(start(["-m", "whisper_mlx_tpu_torch.parallel.launch", target,
                                    "--rank", str(r), "--world", str(world),
                                    "--coordinator", coordinator, "--dir", str(tmp)],
                                   logs[-1], env))
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"run_ranks({target}, world={world}): rank(s) {bad} failed or "
                               f"ran past {timeout_s:g} s:\n" + "\n".join(
                                   f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                                   f"{tail(logs[r])}" for r in bad))
        return [pickle.loads((tmp / f"rank{r}.out").read_bytes()) for r in range(world)]


def _load(target: str):
    path, name = target.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="one rank of run_ranks")
    parser.add_argument("target")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--coordinator", required=True)
    parser.add_argument("--dir", required=True)
    args = parser.parse_args(argv)
    out = Path(args.dir)
    kwargs = pickle.loads((out / "kwargs.pkl").read_bytes())
    result = _load(args.target)(rank=args.rank, world=args.world,
                                coordinator=args.coordinator, **kwargs)
    (out / f"rank{args.rank}.out").write_bytes(pickle.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
