"""Checkpoint / resume for long scenario sweeps.

Port of lbmpc_tpu/runtime/checkpoint.py (the reference's closest analogs:
the workspace .mat snapshots, examples/DSS_NMPC.m:1-5, and the cached
terminal set, functions/getCONS.m:56-58): versioned npz snapshots of the
closed loop's carry — plant states, oracle windows, warm starts, step index
— in the reference's format (FORMAT_VERSION 1, the same keys, `meta` as
JSON), so a checkpoint written by either package loads in the other. A batched
checkpoint resumes re-sharded over a scenario mesh (runtime/sharding).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch

from lbmpc_tpu_torch.oracle import DataWindow

FORMAT_VERSION = 1


@dataclasses.dataclass
class EpisodeState:
    """Resumable mid-episode state (batched over scenarios, or one)."""

    step: int
    x_abs: np.ndarray            # (B, n) plant states
    window_X: np.ndarray         # (B, q, d_in)
    window_Y: np.ndarray         # (B, q, d_out)
    window_valid: np.ndarray     # (B, q)
    window_count: np.ndarray     # (B,)
    z_warm: np.ndarray           # (B, nz)
    rng_key: np.ndarray | None = None   # carried as the opaque array it is


def save(path, state: EpisodeState, meta: dict[str, Any] | None = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        step=state.step,
        x_abs=np.asarray(state.x_abs),
        window_X=np.asarray(state.window_X),
        window_Y=np.asarray(state.window_Y),
        window_valid=np.asarray(state.window_valid),
        window_count=np.asarray(state.window_count),
        z_warm=np.asarray(state.z_warm),
        rng_key=np.asarray(state.rng_key) if state.rng_key is not None else np.zeros(0),
        meta=json.dumps(meta or {}),
    )


def load(path) -> tuple[EpisodeState, dict[str, Any]]:
    d = np.load(path, allow_pickle=False)
    ver = int(d["format_version"])
    if ver != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} != {FORMAT_VERSION}")
    rng = d["rng_key"]
    state = EpisodeState(
        step=int(d["step"]),
        x_abs=d["x_abs"],
        window_X=d["window_X"],
        window_Y=d["window_Y"],
        window_valid=d["window_valid"],
        window_count=d["window_count"],
        z_warm=d["z_warm"],
        rng_key=rng if rng.size else None,
    )
    return state, json.loads(str(d["meta"]))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def capture(result, step: int) -> EpisodeState:
    """EpisodeState from a finished (partial) episode's ClosedLoopResult:
    numpy copies of its resume tuple (final_x, final_window, final_z —
    runtime/closed_loop.py), from any device; `step` records how many steps
    the episode has advanced. Single and batched results alike."""
    w = result.final_window
    return EpisodeState(
        step=step,
        x_abs=_host(result.final_x),
        window_X=_host(w.X),
        window_Y=_host(w.Y),
        window_valid=_host(w.valid),
        window_count=_host(w.count),
        z_warm=_host(result.final_z),
    )


def resume(scenario, state: EpisodeState, steps: int, mesh=None):
    """Continue an episode from a checkpoint: `steps` further closed-loop
    steps from the carry in `state` (plant state, oracle window, warm start)
    on the scenario's device. A single-lane checkpoint resumes through
    Scenario.episode_from, a batched one (leading scenario axis on x_abs)
    through Scenario.episode_from_batch, from the checkpoint's plant state
    itself (x_abs, not x_wp + (x_abs - x_wp), which may round away from it
    and part the episodes where a solve is sensitive): interrupted-then-
    resumed repeats the uninterrupted episode's computation
    (tests/test_torch_checkpoint.py).
    `mesh`: a scenario mesh (runtime/sharding.scenario_mesh) over which a
    batched checkpoint is re-sharded, each shard resumed through
    episode_from_batch on its device, the result in scenario order (this
    rank's lanes with a process group up); an unbatched checkpoint
    raises ValueError, as the reference's does."""
    x_abs = np.asarray(state.x_abs)
    if mesh is not None and x_abs.ndim < 2:
        raise ValueError("mesh resume requires a batched checkpoint")
    window = DataWindow(*(torch.as_tensor(np.asarray(a)) for a in (
        state.window_X, state.window_Y, state.window_valid, state.window_count)))
    dx = x_abs - np.asarray(scenario.cfg.plant.x_wp)
    if mesh is not None:
        from lbmpc_tpu_torch.runtime.sharding import sharded_episode_runner

        def episode(carry):
            dx_s, window_s, z_s, x_s = carry
            return scenario.episode_from_batch(dx_s, window_s, z_s, steps=steps,
                                               x_abs=x_s)

        carry = (torch.as_tensor(dx), window, torch.as_tensor(np.asarray(state.z_warm)),
                 torch.as_tensor(x_abs))
        return sharded_episode_runner(episode, mesh)(carry)
    episode = scenario.episode_from_batch if dx.ndim > 1 else scenario.episode_from
    return episode(dx, window, state.z_warm, steps=steps, x_abs=x_abs)
