"""PyTorch port, runtime/sharding across processes: two gloo ranks on the
CPU (subprocesses on this host, as tests/test_multihost.py runs the
reference's jax.distributed pair) join through initialize_multihost, reduce
their solve flags with global_solve_stats, and run lqr_cross_sharded with
one stage block each; every rank's sweep equals the single-process sweep
over two CPU shards bit for bit."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded, stage_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from lbmpc_tpu_torch.runtime.sharding import (global_solve_stats, initialize_multihost,
                                              scenario_mesh)
from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded, stage_mesh
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_multihost(f"localhost:{port}", num_processes=2, process_id=pid, backend="gloo")
initialize_multihost(f"localhost:{port}", num_processes=2, process_id=pid)   # returns at once
import torch.distributed as dist
mesh = scenario_mesh(devices=["cpu"])
assert mesh.size == 2 and list(mesh.local) == [pid]
# each process holds 4 scenario flags, 2 of them converged
n_conv, n_tot = global_solve_stats(mesh, torch.tensor([True, False, True, False]))
print("RESULT", n_conv, n_tot, dist.get_world_size(), flush=True)
args = [torch.tensor(a) for a in np.load(out + ".in.npz").values()]
W, C = lqr_cross_sharded(stage_mesh(devices=["cpu"]), *args)
np.savez(out + f".{pid}.npz", W=W.numpy(), C=C.numpy())
dist.destroy_process_group()
"""


def _problem():
    from test_torch_riccati_sharded import _problem as p

    return p(30, 8, 1, 3, np.random.default_rng(5))


def test_two_gloo_ranks_reduce_and_split_the_sweep(tmp_path):
    worker = tmp_path / "mh_worker.py"
    worker.write_text(_WORKER)
    out = str(tmp_path / "sweep")
    args = _problem()
    np.savez(out + ".in.npz", *args)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=180)
            outs.append(text)
            assert p.returncode == 0, text[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for text in outs:
        lines = [line for line in text.splitlines() if line.startswith("RESULT")]
        assert lines and lines[0].split() == ["RESULT", "4", "8", "2"], text[-2000:]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        W, C = lqr_cross_sharded(stage_mesh(devices=["cpu"] * 2),
                                 *(torch.tensor(a) for a in args))
    finally:
        torch.set_num_threads(threads)
    for pid in (0, 1):
        got = np.load(out + f".{pid}.npz")
        np.testing.assert_array_equal(got["W"], W.numpy())
        np.testing.assert_array_equal(got["C"], C.numpy())
