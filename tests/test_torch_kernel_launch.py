"""K1w's and K5's launch shapes and K1w's reductions, on the CPU.

K1w (csrc/gn_wide.cu) and K5 (csrc/chol.cu) run one lane on one warp and
several lanes a block; the host picks the lanes a block
(ops/gn_kernel.wide_launch, ops/chol_kernel.chol_launch). These tests hold
that choice to the card's limits over the kernels' whole domain, and hold
two pieces of K1w's arithmetic to the function it must reproduce bit for
bit (gn_wide_body.cuh's gnw::lane on a block of gnw::threads(nz)): the
reduce-scatter that closes a stage's 20 NW sums against the xor butterfly
and block sum it replaces, and the walk that maps a lane's entries of the
packed triangle of H to their rows and columns. The kernels themselves run
only on the card (tests/test_torch_gpu.py).
"""

import pathlib
import re

import numpy as np
import pytest

from lbmpc_tpu_torch.ops import chol_kernel, gn_kernel
from lbmpc_tpu_torch.ops.chol_kernel import (MAX_LANES, WARP_N_MAX, chol_launch,
                                             chol_smem_bytes)
from lbmpc_tpu_torch.ops.gn_kernel import (WIDE_MAX_LANES, wide_launch, wide_smem_bytes,
                                           wide_virtual_warps)
from lbmpc_tpu_torch.ops.qp_kernel import SMEM_OPTIN

SMS = 132
BATCHES = (0, 1, 2, 3, 24, 96, 131, 132, 133, 264, 300, 1000, 1024, 2048, 4095, 8192)
CSRC = pathlib.Path(gn_kernel.__file__).resolve().parent.parent / "csrc"


def _consts(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def _wide_q_max(nz: int) -> int:
    """The largest window one K1w lane holds at nz."""
    q = 1
    while wide_smem_bytes(nz, q + 1, 1) <= SMEM_OPTIN:
        q += 1
    return q


def _check_grid(lanes, blocks, B, most):
    assert 1 <= lanes <= most
    assert blocks == -(-B // lanes) and blocks * lanes >= B > (blocks - 1) * lanes


@pytest.mark.parametrize("nz", [2, 3, 32, 33, 41, 63, 64, 65, 96, 97, 101, 127, 128])
def test_wide_launch_fits_the_card(nz):
    """K1w at every sampled (nz, q, B): at least one lane and at most
    WIDE_MAX_LANES a block, the grid covers B, the block's shared memory
    is wide_smem_bytes and within the H100's opt-in limit; the NW sums keep
    gnw::threads(nz) / 32 virtual warps."""
    q_max = _wide_q_max(nz)
    for q in sorted({1, 2, 7, 100, 101, 500, 1000, q_max // 2, q_max}):
        for B in BATCHES:
            lanes, blocks, smem = wide_launch(nz, q, B, sms=SMS)
            _check_grid(lanes, blocks, B, WIDE_MAX_LANES)
            assert smem == wide_smem_bytes(nz, q, lanes) <= SMEM_OPTIN
            assert lanes & (lanes - 1) == 0
    assert wide_virtual_warps(nz) == (64 if nz <= 64 else 128) // 32


def test_wide_launch_over_the_whole_domain():
    """Every nz 2-128 at the presets' q=100 and the largest q a lane holds,
    at the fleet's and the DMS flagship's batches."""
    for nz in range(2, 129):
        for q in (100, _wide_q_max(nz)):
            for B in (24, 1024, 8192):
                lanes, blocks, smem = wide_launch(nz, q, B, sms=SMS)
                _check_grid(lanes, blocks, B, WIDE_MAX_LANES)
                assert smem <= SMEM_OPTIN


def test_wide_launch_small_batches_and_the_main_shapes():
    """Up to the SM count a lane has a block of its own (the repair's 24
    lanes see one lane's latency); the N40 fleet (nz=41, B=8192) gets 8
    lanes a block; the DMS flagship (nz=101, B=1024) 4, so every SM gets a
    block; a window too large for 8 lanes a block gets fewer, not a
    failure."""
    for B in range(1, SMS + 1):
        assert wide_launch(41, 100, B, sms=SMS)[:2] == (1, B)
    assert wide_launch(41, 100, 8192, sms=SMS)[:2] == (8, 1024)
    assert wide_launch(101, 100, 1024, sms=SMS)[:2] == (4, 256)
    assert wide_launch(101, 100, 2048, sms=SMS)[:2] == (8, 256)
    lanes = wide_launch(128, 100, 8192, sms=SMS)[0]
    assert lanes == 4 and wide_smem_bytes(128, 100, 8) > SMEM_OPTIN


def test_wide_launch_rejects_what_the_kernel_does_not_take():
    for nz, q, B in ((1, 100, 8), (129, 100, 8), (41, 0, 8), (41, 100, -1)):
        with pytest.raises(ValueError):
            wide_launch(nz, q, B, sms=SMS)
    with pytest.raises(ValueError, match="shared memory"):
        wide_launch(128, _wide_q_max(128) + 1, 8, sms=SMS)


@pytest.mark.parametrize("n0", [1, 17, 33, 65, 97])
def test_chol_launch_fits_the_card(n0):
    """K5 at every n (in slices of the domain 1-128) and sampled batch: a
    warp a lane up to WARP_N_MAX, at most MAX_LANES a block, a block of
    its own above; the grid covers B; shared memory is chol_smem_bytes and
    within the opt-in limit."""
    for n in range(n0, min(n0 + 32, 129)):
        for B in BATCHES:
            lanes, blocks, smem = chol_launch(n, B, sms=SMS)
            _check_grid(lanes, blocks, B, MAX_LANES if n <= WARP_N_MAX else 1)
            assert smem == chol_smem_bytes(n, lanes) <= SMEM_OPTIN


def test_chol_launch_small_batches_and_the_main_shapes():
    for B in range(1, SMS + 1):
        assert chol_launch(21, B, sms=SMS)[:2] == (1, B)
    assert chol_launch(21, 8192, sms=SMS)[:2] == (8, 1024)
    assert chol_launch(21, 2048, sms=SMS)[:2] == (8, 256)
    assert chol_launch(101, 1024, sms=SMS)[:2] == (1, 1024)
    # n=21: rows of 8 ceil(21 / 8) + 1 = 25 floats; n=101: the square, b, panel
    assert chol_smem_bytes(21, 8) == 4 * 8 * 21 * 25
    assert chol_smem_bytes(101, 1) == 4 * (101 * 101 + 101 + 16)


def test_chol_launch_rejects_what_the_kernels_do_not_take():
    for n, B in ((0, 8), (129, 8), (21, -1)):
        with pytest.raises(ValueError):
            chol_launch(n, B, sms=SMS)


def test_host_constants_are_the_kernels():
    """The constants the host sizes launches by are the sources'."""
    gw, ch, cb = _consts("gn_wide.cu"), _consts("chol.cu"), _consts("chol_body.cuh")
    assert gw["kMaxLanes"] == WIDE_MAX_LANES
    assert ch["kMaxLanes"] == MAX_LANES and ch["kWarpNMax"] == WARP_N_MAX
    assert cb["kPanel"] == chol_kernel.PANEL and cb["kBlockThreads"] == chol_kernel.BLOCK_THREADS
    assert cb["kNMax"] == chol_kernel.N_MAX
    body = (CSRC / "gn_wide_body.cuh").read_text()
    assert "threads(int nz) { return nz <= 64 ? 64 : 128; }" in body


# ---- K1w's reductions, emulated in float32 ----------------------------------

def _butterfly(v):
    """gn::warp_sum over the 32 lanes of v (..., 32): v += shfl_xor(v, off)."""
    v = v.astype(np.float32).copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(np.float32)
    return v


def _reduce_scatter(v):
    """csrc/gn_wide.cu reduce_scatter on v (20, 32): the value each lane
    returns (32,)."""
    v = v.astype(np.float32).copy()
    lanes = np.arange(32)
    bit = lambda k: (lanes >> k) & 1 == 1

    def step(keep, send, off):
        return (keep + send[lanes ^ off]).astype(np.float32)

    for j in range(10):
        b = bit(4)
        v[j] = step(np.where(b, v[j + 10], v[j]), np.where(b, v[j], v[j + 10]), 16)
    for j in range(5):
        b = bit(3)
        v[j] = step(np.where(b, v[j + 5], v[j]), np.where(b, v[j], v[j + 5]), 8)
    for j in range(2):
        b = bit(2)
        v[j] = step(np.where(b, v[j + 3], v[j]), np.where(b, v[j], v[j + 3]), 4)
    v[2] = step(v[2], v[2], 4)
    b = bit(1)
    v[0] = step(np.where(b, v[1], v[0]), np.where(b, v[0], v[1]), 2)
    v[2] = step(v[2], v[2], 2)
    b = bit(0)
    return step(np.where(b, v[2], v[0]), np.where(b, v[0], v[2]), 1)


def _rs_lane(i: int) -> int:
    """csrc/gn_wide.cu rs_lane."""
    return 16 * (i // 10) + 8 * (i % 10 // 5) + (0, 2, 1, 4, 6)[i % 5]


def _scales(rng, shape):
    """float32 values over many magnitudes and both signs, with ties of
    magnitude, so any reassociation shows."""
    return (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 7, shape)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_reduce_scatter_is_the_butterfly_bit_for_bit(seed):
    """Each of the 20 sums, read from the lane rs_lane names, equals the xor
    butterfly's value bit for bit, on random float32 data over 13 decades."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        v = _scales(rng, (20, 32))
        got = _reduce_scatter(v)
        want = _butterfly(v)[:, 0]
        assert all(got[_rs_lane(i)].tobytes() == want[i].tobytes() for i in range(20))
    assert sorted({_rs_lane(i) for i in range(20)}) == sorted(_rs_lane(i) for i in range(20))


@pytest.mark.parametrize("nz, q", [(41, 100), (101, 100), (64, 37), (65, 300), (128, 1)])
def test_nw_sums_keep_the_block_order(nz, q):
    """A stage's 20 NW sums as gnw::lane forms them on T = gnw::threads(nz)
    threads (thread c sums points c, c + T, ...; each warp's butterfly; the
    warps' sums added in order from 0) and as K1w forms them on one warp
    (lane l sums virtual warp w's points l + 32 w + j T apart; a
    reduce-scatter a virtual warp; the virtual warps added in order from
    0): equal bit for bit."""
    rng = np.random.default_rng(nz * 1000 + q)
    V = wide_virtual_warps(nz)
    T = 32 * V
    pts = _scales(rng, (q, 20))
    part = np.zeros((V, 20, 32), np.float32)      # [warp w, sum, lane l] = thread l + 32 w
    for p in range(q):
        c = p % T
        part[c // 32, :, c % 32] = (part[c // 32, :, c % 32] + pts[p]).astype(np.float32)
    block = np.zeros(20, np.float32)
    for w in range(V):
        block = (block + _butterfly(part[w])[:, 0]).astype(np.float32)
    tot = np.zeros(32, np.float32)
    for w in range(V):
        tot = (tot + _reduce_scatter(part[w])).astype(np.float32)
    assert all(tot[_rs_lane(i)].tobytes() == block[i].tobytes() for i in range(20))


def test_lane_walk_visits_the_packed_triangle_in_order():
    """csrc/gn_wide.cu add_rows: lane l starts at entry l's (row, column) of
    the packed lower triangle and steps 32 entries by walking along the
    rows; over the whole triangle at nz = 128 every lane lands on each of
    its entries' true row and column."""
    tri = lambda i: i * (i + 1) // 2
    rows = np.repeat(np.arange(128), np.arange(1, 129))
    cols = np.arange(tri(128)) - np.array([tri(i) for i in rows])
    for lane in range(32):
        i = 0
        while tri(i + 1) <= lane:
            i += 1
        c = lane - tri(i)
        for e in range(lane, tri(128), 32):
            assert (i, c) == (rows[e], cols[e])
            c += 32
            while c > i:
                c -= i + 1
                i += 1
