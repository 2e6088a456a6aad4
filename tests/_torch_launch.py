"""Worker processes of the port's multi-process tests on the CPU
(``tests/_torch_ddp_worker.py``), each rank joining over gloo on
localhost: a spec a process, all started at once, each under a process
timeout, so that a dead rank fails its test instead of hanging the suite."""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_ddp_worker.py")
PROC_TIMEOUT = 400


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(specs: list[dict], fail: bool = False) -> list:
    """Start every spec's worker at once; wait for all under the process
    timeout (killing the rest when one fails or times out); their results.
    With ``fail``, every worker must fail instead: their outputs."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, json.dumps(s)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s in specs]
    try:
        outs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if fail:
        assert all(p.returncode != 0 for p in procs), [p.returncode for p in procs]
        return outs
    for s, p, out in zip(specs, procs, outs):
        assert p.returncode == 0, f"rank {s['rank']} of {s['world']}: rc {p.returncode}\n" \
                                  f"{out[-4000:]}"
    results = []
    for s, out in zip(specs, outs):
        with open(s["out_json"]) as f:
            results.append({**json.load(f), "stdout": out})
    return results


def _spec(tmp, name: str, **kw) -> dict:
    return {"world": 0, "rank": 0, "port": 0, "out_json": str(tmp / f"{name}.json"), **kw}


def _world(tmp, name: str, world: int, **kw) -> list[dict]:
    port = _free_port()
    return [_spec(tmp, f"{name}{r}", world=world, rank=r, port=port, **kw)
            for r in range(world)]
