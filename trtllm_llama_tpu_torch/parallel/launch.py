"""Start N ranks of a worker on one machine, each in its own process.

    results = launch("my_module:run", 2, args=("out_dir",), backend="gloo")

starts `python -m trtllm_llama_tpu_torch.parallel.launch <spec>` N times.
Each rank initialises `torch.distributed` (`tcp://127.0.0.1:<free port>`,
the caller's backend, a collective timeout), imports the worker function
and calls `fn(rank, world_size, *args)`, then destroys the process group.
The caller joins the ranks under a timeout of its own; as soon as one rank
fails, or the timeout passes, it kills the ranks still running (exactly
the PIDs it started) so that no rank waits out its collectives on a dead
peer. It returns each rank's exit code and output (stdout and stderr
together). Neither this module nor the ranks import JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int     # negative: killed (a failed peer, the join timeout)
    output: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def free_port() -> int:
    """A TCP port on the loopback interface that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, nprocs: int, args=(), backend: str = "gloo",
           collective_timeout: float = 60.0, join_timeout: float = 120.0,
           env=None, cwd=None, sys_path=()) -> list:
    """Run target ("module:function") on nprocs ranks; returns a
    RankResult per rank. args: JSON-serialisable extra arguments; env: the
    ranks' environment (default this process's; the package's directory is
    put on PYTHONPATH); sys_path: directories the
    ranks put first on sys.path to import the worker module."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    # the ranks import this package from where it lies
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    procs, logs = [], []
    try:
        for rank in range(nprocs):
            spec = {"target": target, "rank": rank, "world": nprocs,
                    "port": port, "backend": backend,
                    "timeout": collective_timeout, "args": list(args),
                    "sys_path": [str(p) for p in sys_path]}
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, json.dumps(spec)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=cwd))
        deadline = time.monotonic() + join_timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(
                    c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()            # the PIDs started here, never by pattern
        for p in procs:
            p.wait()
    results = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out = log.read()
        log.close()
        results.append(RankResult(rank, p.returncode, out))
    return results


def check(results) -> None:
    """Raise with every failed rank's output unless all ranks exited 0."""
    bad = [r for r in results if not r.ok]
    if bad:
        raise RuntimeError("\n".join(
            f"rank {r.rank} exited {r.returncode}:\n{r.output[-6000:]}"
            for r in bad))


def _main(spec: dict) -> int:
    import torch.distributed as dist
    for p in reversed(spec["sys_path"]):
        sys.path.insert(0, p)
    dist.init_process_group(
        spec["backend"], init_method=f"tcp://127.0.0.1:{spec['port']}",
        rank=spec["rank"], world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        module, fn = spec["target"].split(":")
        getattr(importlib.import_module(module), fn)(
            spec["rank"], spec["world"], *spec["args"])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        code = _main(json.loads(sys.argv[1]))
    except BaseException:       # noqa: BLE001 - the rank reports and fails
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)     # no exit handlers: a peer's dead sockets cannot hang it
