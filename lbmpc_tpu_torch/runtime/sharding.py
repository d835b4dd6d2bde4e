"""Scenario-axis sharding over devices and processes.

Port of lbmpc_tpu/runtime/sharding.py. The reference lays a 1-D
`jax.sharding.Mesh` over the scenario axis and lets XLA partition the
closed loop; the cross-chip reductions ride `psum`. Here:

  - a `Mesh` is the ordered list of the axis's shards. A shard is a device
    of this process; repeats are allowed, so 8 shards may sit on "cpu" (the
    reference's tests use 8 virtual CPU devices) or two on one "cuda:0".
    With a `torch.distributed` group up, the axis spans every rank: each
    rank holds the same number of shards, rank-major, and keeps only its
    own;
  - the runners run a batched episode function on each of this rank's
    shards, its inputs on the shard's device, and return the results in
    scenario order. The shards run one after the other in a process; the
    ranks run side by side;
  - every exchange between ranks is one `dist.all_reduce(SUM)`: a rank
    writes its part into its slot of a zero stack and the sum completes the
    stack. Adding zeros is exact, and all_reduce takes CPU and CUDA tensors
    on gloo and CUDA tensors on NCCL (gloo has no CUDA all_gather, and NCCL
    refuses two ranks on one card).

Lane-coupled solvers. `HybridSolver` repairs the K = round(B repair_frac)
lanes flagged first over the whole batch (controllers/sqp_fused.repair_pick).
The reference's split hybrid is that global function under jit, so it equals
the unsplit call. A per-shard call would pick K/D lanes a shard and differ
wherever one shard holds more flagged lanes than its share. `split_solver`
keeps the reference's meaning: the fused solve runs per shard, the flags
(one bool a lane) are gathered over the shards and the ranks, the K lanes
are picked from the whole batch, and each picked lane is repaired on the
shard that holds it (the repair is lane-local, so the lanes' work need not
move). An episode built with `build_fleet_episode(..., mesh=mesh)` solves
through it; the runners see its `.mesh` and hand it this rank's lanes whole.

100k+ concurrent receding-horizon instances = ranks x shards x cohort.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.oracle import DataWindow


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Join a `torch.distributed` process group. With the arguments given,
    the group meets at `coordinator_address` ("host:port", or a URL such as
    "tcp://localhost:29500") with `num_processes` ranks, this one
    `process_id`; without them it reads torchrun's environment (env://).
    The backend is NCCL where CUDA is available and gloo otherwise, unless
    named. Returns at once when a group is already up (the reference's
    guard, lbmpc_tpu/runtime/sharding.py:43-47)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ordered shards of one axis. `devices`: this rank's shards'
    devices, in order; with a process group up, ranks hold `len(devices)`
    shards each, rank-major."""

    devices: tuple
    axis: str = "scenario"
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def size(self) -> int:
        """Shards on the axis, over every rank."""
        return self.world * len(self.devices)

    @property
    def local(self) -> range:
        """This rank's shards' positions on the axis."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks in place (no-op without a group)."""
        if self.distributed:
            _dist().all_reduce(t)
        return t


def scenario_mesh(n_devices: int | None = None, axis: str = "scenario",
                  devices=None) -> Mesh:
    """A 1-D mesh on `axis`. `devices` names this rank's shards (repeats
    allowed, e.g. ["cpu"] * 8); otherwise every local CUDA device, or one a
    rank (cuda:LOCAL_RANK) with a process group up. `n_devices` takes the
    first n shards; in a process, more shards than cards repeat the cards
    in turn. With no CUDA device and no `devices`, it raises: there is no
    quiet CPU mesh."""
    dist = _dist()
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scenario_mesh: no CUDA device; name the shards' devices, "
                "e.g. devices=['cpu'] * 8")
        count = torch.cuda.device_count()
        if dist:
            local = int(os.environ.get("LOCAL_RANK", rank % count))
            devices = [torch.device("cuda", local)]
        else:
            devices = [torch.device("cuda", i) for i in range(max(count, n_devices or 0))]
            devices = [torch.device("cuda", d.index % count) for d in devices]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if world > 1 and n_devices != world * len(devices):
            raise ValueError(f"n_devices={n_devices}: a mesh over {world} ranks "
                             f"spans all {world * len(devices)} shards")
        if world == 1:
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("scenario_mesh: no shards")
    return Mesh(devices=devices, axis=axis, rank=rank, world=world,
                distributed=dist is not None)


class Sharded(NamedTuple):
    """This rank's shards of a batch: `parts[i]` holds the lanes of shard
    `index[i]`, on that shard's device."""

    parts: tuple
    index: tuple


def _map(fn, tree):
    """fn over the tensors of a tensor / (named) tuple / list tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, np.ndarray):
        return fn(torch.as_tensor(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, a) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, a) for a in tree)
    raise TypeError(f"cannot shard a {type(tree).__name__}")


def _leaves(tree) -> list:
    out = []
    _map(lambda a: out.append(a) or a, tree)
    return out


def _concat(trees, device):
    """The leafwise concatenation of `trees` along the lanes, on `device`."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(None if a is None else _concat([t[i] for t in trees], device)
                             for i, a in enumerate(first)))
    return type(first)(_concat([t[i] for t in trees], device) for i in range(len(first)))


def _lanes(tree) -> int:
    return _leaves(tree)[0].shape[0]


def shard_scenarios(mesh: Mesh, tree) -> Sharded:
    """Split the leading (scenario) axis of every tensor in `tree` into the
    mesh's shards, in order, each on its shard's device; this rank keeps
    its own. A batch the shards do not divide raises ValueError."""
    B = _lanes(tree)
    if B % mesh.size:
        raise ValueError(f"batch {B} is not a multiple of the {mesh.size} shards "
                         f"of the '{mesh.axis}' axis")
    b = B // mesh.size
    parts = tuple(_map(lambda a, j=j, d=d: a[j * b:(j + 1) * b].to(d), tree)
                  for j, d in zip(mesh.local, mesh.devices))
    return Sharded(parts=parts, index=tuple(mesh.local))


def _shards(mesh: Mesh, batch) -> Sharded:
    return batch if isinstance(batch, Sharded) else shard_scenarios(mesh, batch)


def _on(dev):
    """The device context a shard's work runs in (the current card)."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run_shards(episode_fn: Callable, mesh: Mesh, batch):
    """episode_fn on each of this rank's shards of `batch`, the results
    joined in scenario order on the first shard's device. An episode that
    splits its own solver over this mesh (`.mesh`) takes the rank's lanes
    whole."""
    sh = _shards(mesh, batch)
    if getattr(episode_fn, "mesh", None) is mesh:
        with _on(mesh.devices[0]):
            return episode_fn(_concat(list(sh.parts), mesh.devices[0]))
    outs = []
    for part, d in zip(sh.parts, mesh.devices):
        with _on(d):
            outs.append(episode_fn(part))
    return _concat(outs, mesh.devices[0])


def sharded_episode_runner(episode_fn: Callable, mesh: Mesh) -> Callable:
    """run(batch) for a batched episode function (dx (B, n) ->
    ClosedLoopResult, histories batch-first: Scenario.run_batch, a
    build_fleet_episode run): each shard's lanes through `episode_fn` on its
    device, the ClosedLoopResult in scenario order (this rank's lanes with
    a group up). `batch` is the whole batch or shard_scenarios' split. For
    a lane-local episode the result equals the unsplit call."""

    def run(batch):
        return _run_shards(episode_fn, mesh, batch)

    return run


def fleet_runner(episode_fn: Callable, mesh: Mesh, chunk: int) -> Callable:
    """Runner for very large fleets: run(dx_all (F, n)) sweeps cohorts of
    `chunk` scenarios through the mesh, each cohort split over the shards
    (the reference's chunk axis sharded over the mesh), and returns the
    ClosedLoopResult with leading axis F (this rank's lanes of every cohort,
    in fleet order, with a group up). F must be a multiple of `chunk` and
    `chunk` of the mesh's shards; anything else raises ValueError, as the
    reference does."""
    if chunk % mesh.size:
        raise ValueError(f"chunk {chunk} is not a multiple of the {mesh.size} shards")

    def run_fleet(dx_all):
        F = dx_all.shape[0]
        if F % chunk:
            raise ValueError(f"fleet size {F} not a multiple of chunk {chunk}")
        outs = [_run_shards(episode_fn, mesh, dx_all[i:i + chunk])
                for i in range(0, F, chunk)]
        return _concat(outs, mesh.devices[0])

    return run_fleet


class SplitSolver:
    """A batch solver (FusedSolver or HybridSolver: raw(dx0, windows, z_ws)
    -> (z, conv)) split over a mesh's shards: the lane-local fused solve runs
    each shard's lanes on its device; a hybrid's repair picks its K lanes
    from the flags of the whole batch (every shard, every rank) and repairs
    each on the shard that holds it. `raw` takes this rank's lanes, which
    the shards divide, and returns them in order on the first argument's
    device; `raw_qpwarm` also splits the carried interior state."""

    def __init__(self, mesh: Mesh, solver):
        self.mesh = mesh
        self.solver = solver
        self.hybrid = hasattr(solver, "repair")
        self.fused = solver.fused if self.hybrid else solver
        self.device = solver.device
        self.init_qp_state = solver.init_qp_state

    def __call__(self, dx0, windows: DataWindow, z_ws):
        dev = self.device
        f32 = torch.float32
        return self.raw(dx0.to(dev, f32), windows.to(f32, dev), z_ws.to(dev, f32))

    def _parts(self, tree) -> list:
        L = len(self.mesh.devices)
        b = _lanes(tree) // L
        if b * L != _lanes(tree):
            raise ValueError(f"{_lanes(tree)} lanes are not a multiple of this rank's "
                             f"{L} shards")
        return [_map(lambda a, i=i, d=d: a[i * b:(i + 1) * b].to(d), tree)
                for i, d in enumerate(self.mesh.devices)]

    def _solve(self, dx0, windows, z_ws, qp_state):
        parts = self._parts((dx0, windows, z_ws, qp_state))
        outs = []
        for (dx, win, z, st), d in zip(parts, self.mesh.devices):
            with _on(d):
                if qp_state is None:
                    outs.append(self.fused.raw(dx, win, z) + (None,))
                else:
                    outs.append(self.fused.raw_qpwarm(dx, win, z, st))
        if self.hybrid:
            outs = self._repair(parts, outs)
        z, conv, st = _concat(outs, dx0.device) if qp_state is not None else (
            *_concat([o[:2] for o in outs], dx0.device), None)
        return z, conv, st

    def _repair(self, parts, outs) -> list:
        """The hybrid's repair over the whole batch: the K lanes flagged
        first (repair_pick on the gathered flags), each repaired on its
        shard."""
        from lbmpc_tpu_torch.controllers.sqp_fused import repair_at, repair_pick

        mesh, s = self.mesh, self.solver
        b = outs[0][1].shape[0]
        flags = torch.zeros(mesh.size * b, dtype=torch.int32, device=mesh.devices[0])
        for j, o in zip(mesh.local, outs):
            flags[j * b:(j + 1) * b] = o[1].to(flags.device, torch.int32)
        mesh.all_reduce(flags)
        conv_all = flags.bool()
        B = conv_all.shape[0]
        K = max(1, min(B, int(round(B * s.repair_frac))))
        idx = repair_pick(conv_all, K)
        idx = idx[~conv_all[idx]]               # the picked lanes that are flagged
        fixed = []
        for j, (dx, win, z_ws, _), (z, conv, st) in zip(mesh.local, parts, outs):
            mine = idx[(idx >= j * b) & (idx < (j + 1) * b)] - j * b
            if mine.numel():
                with _on(z.device):
                    z, conv = repair_at(s.repair, mine.to(z.device),
                                        s.repair_warm == "fused", z, conv, dx, win, z_ws)
            fixed.append((z, conv, st))
        return fixed

    def raw(self, dx0, windows: DataWindow, z_ws):
        return self._solve(dx0, windows, z_ws, None)[:2]

    def raw_qpwarm(self, dx0, windows: DataWindow, z_ws, qp_state):
        return self._solve(dx0, windows, z_ws, qp_state)


def split_solver(mesh: Mesh, solver) -> SplitSolver:
    """`solver` split over `mesh` (SplitSolver): per shard where the work is
    lane-local, over the whole batch where a hybrid's repair picks lanes."""
    return SplitSolver(mesh, solver)


# Per-backend constants of estimate_fleet_budget, calibrated on one NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit (tools/fleet_budget_calibration.py:
# torch.cuda.max_memory_allocated over a 2-step fleet episode, N=20, q=32,
# mI=214, float32; a lane's bytes are the slope between cohorts 1024 and
# 8192, and each coefficient puts the model's per-lane work on it):
#   fused_xla (the port's xla route, the reference's "fused_xla" backend):
#     29,547 bytes a lane -> kkt_copies 0.554 copies of the (mI x nz)
#     constraint stack (the reference's v5e XLA program held 33);
#   pallas_full: 11,134 bytes a lane -> staging 3.133 copies of the
#     kernels' staged H, h and e; the warm chain 12,846 -> chain 2.0 (mI)
#     rows a lane more.
# From 8192 to 32768 the slopes were 29,385, 10,935 and 12,647 bytes.
# validated_to: the largest cohort run on the card with that backend.
FLEET_BUDGET = {
    "fused_xla": dict(kkt_copies=0.554, validated_to=32768),
    "pallas_full": dict(staging=3.133, chain=2.0, validated_to=32768),
}


def _device_memory() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("estimate_fleet_budget: no CUDA device; pass hbm_bytes")
    return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory


def estimate_fleet_budget(
    *,
    n: int,
    m: int,
    nth: int,
    N: int,
    q: int,
    iterations: int,
    fleet: int,
    d_in: int = 3,
    d_out: int = 4,
    history_bytes: int = 4,
    work_bytes: int = 4,
    hbm_bytes: int | None = None,
    safety: float = 2.5,
    mI: int | None = None,
    fused_kkt_copies: float | None = None,
    backend: str = "fused_xla",
    warm_chain: bool = False,
) -> dict:
    """Device-memory budget model for fleet episodes: the reference's
    keywords, formula and returned keys (lbmpc_tpu/runtime/sharding.py:
    118-231), with the card's own constants (FLEET_BUDGET; hbm_bytes
    defaults to the current card's total memory).

    Two resident terms:
      - fleet outputs: every cohort's ClosedLoopResult stays, so the whole
        fleet's histories live at once — iterations * (n + 2m + 1) numbers
        an instance;
      - cohort working set: a lane's solver live set. On "fused_xla" the
        QP's KKT intermediates (kkt_copies of the mI x nz stack), the GN
        Jacobian (ne x nz), the (nz x nz) factor buffers and the oracle
        window; on "pallas_full" the kernels' staged H, h and e (staging
        copies), the window and the z/g/d vectors, plus the warm chain's
        rows.

    `safety` covers the allocator's fragmentation. Returns per_instance_out,
    per_lane_work (bytes), fleet_out, max_chunk (the largest power of two
    whose cohort fits beside the outputs; 0 if the outputs alone do not),
    fits, and validated_to (the largest cohort run on the card with this
    backend; beyond it the model extrapolates)."""
    table = FLEET_BUDGET[backend]
    hbm = _device_memory() if hbm_bytes is None else hbm_bytes
    nz = N * m + nth
    ne = (N - 2) * (n + m) + n + n          # fmincon residual stack
    mI_guess = mI if mI is not None else 30 * N + 640
    per_instance_out = iterations * (n + 2 * m + 1) * history_bytes
    if backend == "pallas_full":
        per_lane_work = work_bytes * (
            table["staging"] * (nz * nz + mI_guess + ne)   # packed H + h + e staging
            + q * (d_in + d_out + 1)                       # oracle window
            + 8 * nz)                                      # z/g/d vectors
        if warm_chain:
            per_lane_work += work_bytes * table["chain"] * mI_guess
    else:
        copies = table["kkt_copies"] if fused_kkt_copies is None else fused_kkt_copies
        per_lane_work = work_bytes * (
            copies * mI_guess * nz        # D-scaled stack + temporaries
            + ne * nz                     # J
            + 4 * nz * nz                 # Hb + M + L + equilibrated copy
            + 2 * mI_guess                # h rows + slack/dual vectors
            + q * (d_in + d_out + 1)      # oracle window
            + 4 * ne)                     # residual + merit temporaries
    fleet_out = fleet * per_instance_out
    avail = hbm / safety - fleet_out
    max_chunk = 0
    if avail > per_lane_work:
        max_chunk = 1 << int(np.floor(np.log2(avail / per_lane_work)))
    return dict(per_instance_out=per_instance_out, per_lane_work=per_lane_work,
                fleet_out=fleet_out, max_chunk=max_chunk, fits=max_chunk >= 1,
                validated_to=table["validated_to"])


def global_solve_stats(mesh: Mesh, converged) -> tuple:
    """(n_converged, n_total) over every shard and rank, as ints, the same
    on every rank: summed locally, then one all_reduce over the group.
    `converged` is this rank's flags: a tensor of its lanes, or
    shard_scenarios' split."""
    parts = converged.parts if isinstance(converged, Sharded) else (converged,)
    dev = mesh.devices[0]
    local = torch.zeros(2, dtype=torch.int64, device=dev)
    for p in parts:
        p = torch.as_tensor(p)
        local[0] += p.to(dev).sum()
        local[1] += p.numel()
    mesh.all_reduce(local)
    return int(local[0]), int(local[1])
