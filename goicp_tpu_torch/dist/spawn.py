"""Run one function on n ranks of a new process group, one process each.

    python -m goicp_tpu_torch.dist.spawn MODULE:FUNCTION N \\
        [--device cpu|cuda:0] [--backend gloo|nccl] [--kwargs JSON]

runs FUNCTION(device=..., **kwargs) in N processes joined by
dist/mesh.init_distributed over tcp://localhost (a free port), and prints
what each rank returned.  From Python, run_ranks does the same and returns
each rank's result (a dict of numpy-convertible values).  device None: each
rank takes the card of its rank number (NCCL); "cpu" runs gloo ranks on the
CPU; a card named by every rank ("cuda:0") lets several ranks share it
(NCCL refuses that, so pass backend "gloo").  On a multi-GPU host,
`torchrun --nproc-per-node N` with init_distributed() (no arguments) is the
other way in.

A rank that fails or outlives timeout_s ends the run: every other rank is
killed, and run_ranks raises with the tail of each rank's output.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target: str, n: int, kwargs: dict | None = None,
              device: str | None = None, backend: str | None = None,
              timeout_s: float = 600.0) -> list[dict]:
    """target "module:function"; returns [rank 0's result, ...]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for rank in range(n):
            cmd = [sys.executable, "-m", "goicp_tpu_torch.dist.spawn",
                   target, str(n), "--rank", str(rank), "--port", str(port),
                   "--out", tmp, "--kwargs", json.dumps(kwargs or {}),
                   "--timeout", str(timeout_s)]
            cmd += ["--device", device] if device else []
            cmd += ["--backend", backend] if backend else []
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        try:
            failure = _wait(procs, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            tails = []
            for rank, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {rank} ---\n{log.read()[-3000:]}")
                log.close()
        if failure:
            raise RuntimeError(f"{target} on {n} ranks: {failure}\n"
                               + "\n".join(tails))
        outs = []
        for rank in range(n):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                outs.append({k: z[k] for k in z.files})
        return outs


def _wait(procs, deadline: float) -> str | None:
    """Wait for every rank; a description of the first failure, or None."""
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            return f"rank {bad[0][0]} exited with code {bad[0][1]}"
        if all(c == 0 for c in codes):
            return None
        if time.monotonic() > deadline:
            return "timed out"
        time.sleep(0.05)


def _rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from goicp_tpu_torch.dist.mesh import init_distributed
    # the ranks share the host's cores: intra-op threads would only
    # contend with the other ranks
    torch.set_num_threads(1)
    device = init_distributed(f"localhost:{args.port}", args.n, args.rank,
                              device=args.device, backend=args.backend,
                              timeout_s=args.timeout)
    module, fn = args.target.split(":")
    out = getattr(importlib.import_module(module), fn)(
        device=device, **json.loads(args.kwargs))
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
             **{k: np.asarray(v) for k, v in (out or {}).items()})
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", help="module:function")
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device")
    ap.add_argument("--backend")
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    outs = run_ranks(args.target, args.n, json.loads(args.kwargs),
                     device=args.device, backend=args.backend,
                     timeout_s=args.timeout)
    for rank, out in enumerate(outs):
        print(f"rank {rank}: " + json.dumps(
            {k: np.asarray(v).tolist() for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
