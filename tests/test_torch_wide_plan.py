"""PyTorch port: the host plan of K2w and K3w (ops/qp_kernel.WidePlan), the
extents by which the wide kernels skip G's structural zeros (the reference's
causal-suffix analysis, lbmpc_tpu/ops/pallas_ipm.py:84-92, kept in G's row
order). Against the reference's analyze_constraint_rows on the DMS
flagship's, the uncut LBMPC_N40's and LBMPC_N50's G and on seeded random G
with prefix structure; the plan covers every structural nonzero product; its
assembly replayed in plain torch equals the dense G' diag(d) G; the layout
the kernels read; a NaN in d stays in M. Host numpy and CPU torch only,
seconds."""

import numpy as np
import pytest
import torch

from lbmpc_tpu.ops.pallas_ipm import analyze_constraint_rows as ref_rows

from lbmpc_tpu_torch.ops.qp_kernel import WidePlan
from lbmpc_tpu_torch.runtime.scenario import build_scenario

PRESETS = ("DMS_LBMPC_q100", "LBMPC_N40", "LBMPC_N50")


@pytest.fixture(scope="module")
def preset_G():
    return {name: np.asarray(build_scenario(name).qp.G, np.float32) for name in PRESETS}


def random_prefix_G(seed: int, mI: int, nz: int, n_split: int = 0) -> np.ndarray:
    """Rows with support [lo, hi) in random order (a condensed QP's causal
    prefix shape), a few all-zero rows, and optionally n_split rows on one
    2-column support (a split-G group)."""
    rng = np.random.default_rng(seed)
    G = np.zeros((mI, nz), np.float32)
    for r in range(mI):
        hi = int(rng.integers(1, nz + 1))
        lo = int(rng.integers(0, hi)) if rng.uniform() < 0.3 else 0
        G[r, lo:hi] = rng.standard_normal(hi - lo) * (rng.uniform(size=hi - lo) > 0.2)
    G[rng.choice(mI, 3, replace=False)] = 0.0
    if n_split:
        rows = rng.choice(mI, n_split, replace=False)
        G[rows] = 0.0
        G[rows, 0] = rng.standard_normal(n_split)
        G[rows, nz - 1] = rng.standard_normal(n_split)
    return G


def all_G(preset_G):
    out = dict(preset_G)
    for seed, (mI, nz, n_split) in enumerate(((300, 37, 0), (1024, 128, 0), (500, 64, 80),
                                              (129, 45, 0))):
        out[f"random{seed}"] = random_prefix_G(seed, mI, nz, n_split)
    return out


def test_plan_matches_reference_row_analysis(preset_G):
    """The extents are the reference's analysis kept in G's row order: each
    row's last nonzero column + 1 is the reference's maxc + 1 (0 for a zero
    row); column c's suffix starts no later than the first row, in G's order,
    of the reference's suffix lo[c] (its rows sorted by maxc), and every row
    the reference puts before lo[c] that lies in the plan's suffix holds a
    zero in column c."""
    for name, G in all_G(preset_G).items():
        plan = WidePlan(G)
        r = ref_rows(G)
        d_rows = np.asarray(r["d_rows"], np.int64)
        maxc = np.asarray([int(np.nonzero(G[i])[0][-1]) if G[i].any() else 0
                           for i in d_rows], np.int64)
        assert np.array_equal(plan.row_hi[d_rows], maxc + 1), name
        lo = np.searchsorted(maxc, np.arange(G.shape[1]))
        assert [int(x) // 128 * 128 for x in lo] == list(r["lo128"]), name
        for c in range(G.shape[1]):
            suffix = d_rows[lo[c]:]
            if suffix.size:
                assert plan.col_start[c] <= suffix.min(), (name, c)
            before = d_rows[:lo[c]]
            assert not G[before[before >= plan.col_start[c]], c].any(), (name, c)
    assert all(ref_rows(G)["mS"] == 0 for G in preset_G.values())


def test_plan_covers_every_structural_nonzero(preset_G):
    """Every nonzero product G[r, i] G[r, j] (i >= j) falls in a tile the
    assembly keeps for r's chunk; every nonzero G[r, c] inside r's row extent
    (G x) and inside column c's suffix (G'v)."""
    for name, G in all_G(preset_G).items():
        plan = WidePlan(G)
        for r in range(G.shape[0]):
            cols = np.nonzero(G[r])[0]
            if not cols.size:
                continue
            tiles = plan.chunk_tiles[r // plan.chunk]
            assert cols.max() // WidePlan.TILE < tiles, (name, r)
            assert plan.row_lo[r] <= cols.min() and cols.max() < plan.row_hi[r], (name, r)
            assert np.all(plan.col_start[cols] <= r), (name, r)
        n_chunks = -(-G.shape[0] // plan.chunk)
        assert plan.chunk_tiles.shape == (n_chunks,)
        assert plan.meta.numel() == 2 * G.shape[0] + G.shape[1] + n_chunks


def test_plan_assembly_equals_dense(preset_G):
    """The plan's chunked, tile-skipping assembly replayed in plain torch
    equals G' diag(d) G: to 1e-12 relative in float64, and in float32 within
    mI float32 roundings of sum |G_ri| d_r |G_rj| entrywise."""
    rng = np.random.default_rng(5)
    for name, G in all_G(preset_G).items():
        plan = WidePlan(G)
        d = np.exp(rng.uniform(-8, 8, size=(3, G.shape[0])))
        for dtype in (torch.float64, torch.float32):
            Gt, dt = torch.tensor(G, dtype=dtype), torch.tensor(d, dtype=dtype)
            M = plan.assemble_plain(dt)
            dense = (Gt.T * dt[:, None, :]) @ Gt
            if dtype == torch.float64:
                scale = dense.abs().amax(dim=(1, 2), keepdim=True)
                assert ((M - dense).abs() / scale).max().item() <= 1e-12, name
            else:
                A = torch.tensor(np.abs(G), dtype=torch.float64)
                mag = (A.T * torch.tensor(d)[:, None, :]) @ A
                tol = G.shape[0] * np.finfo(np.float32).eps * mag
                assert bool(((M.double() - dense.double()).abs() <= tol).all()), name
            assert torch.equal(M, M.transpose(1, 2)), name


def test_plan_layout(preset_G):
    """Gp is G, zero-padded to whole chunks and tiles (the kernels copy it
    in 16-byte pieces); GpT is G transposed; meta packs the extents in the
    kernels' order."""
    for name, G in all_G(preset_G).items():
        plan = WidePlan(G)
        mI, nz = G.shape
        assert torch.equal(plan.Gp[:mI, :nz], torch.tensor(G)), name
        assert plan.Gp.shape[0] % plan.chunk == 0 and plan.Gp.shape[1] % WidePlan.TILE == 0
        assert not plan.Gp[mI:].any() and not plan.Gp[:, nz:].any(), name
        assert torch.equal(plan.GpT, torch.tensor(G).T), name
        meta = plan.meta.numpy()
        parts = np.split(meta, np.cumsum([mI, mI, nz]))
        for got, want in zip(parts, (plan.row_lo, plan.row_hi, plan.col_start,
                                     plan.chunk_tiles)):
            assert np.array_equal(got, want), name


def test_plan_assembly_keeps_a_nan(preset_G):
    """A NaN in one row's d reaches every entry of M that the row touches:
    the lane stays NaN, as in the dense assembly."""
    for name in ("DMS_LBMPC_q100", "LBMPC_N40"):
        G = preset_G[name]
        plan = WidePlan(G)
        d = torch.ones(2, G.shape[0], dtype=torch.float32)
        r = G.shape[0] // 2
        d[1, r] = float("nan")
        M = plan.assemble_plain(d)
        cols = np.nonzero(G[r])[0]
        assert bool(torch.isfinite(M[0]).all())
        assert bool(torch.isnan(M[1][cols][:, cols]).all()), name
