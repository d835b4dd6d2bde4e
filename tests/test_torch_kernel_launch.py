"""The launch shapes of K1, K1w, K4 and K5, and K1's and K1w's reductions,
on the CPU.

K1 (csrc/gn_phase.cu), K1w (csrc/gn_wide.cu) and K5 (csrc/chol.cu) run one
lane on one warp and several lanes a block, K4 (csrc/mehrotra.cu) one lane
on four warps and several lanes a block; the host picks the lanes a block
(ops/gn_kernel.narrow_gn_launch and wide_launch,
ops/chol_kernel.chol_launch, ops/qp_kernel.shared_launch). These tests hold
that choice to the card's limits over the kernels' whole domain and the
host's shared-memory formulas to the sources' constants, and hold pieces of
K1's and K1w's arithmetic to the functions they must reproduce bit for bit:
the reduce-scatter that closes a stage's 20 NW sums against the xor
butterfly (and block sum) it replaces, the walk that maps a lane's entries
of H's lower triangle to their rows and columns, and K1's causal update of
H against the full one. The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import pathlib
import re

import numpy as np
import pytest

from lbmpc_tpu_torch.ops import chol_kernel, gn_kernel
from lbmpc_tpu_torch.ops.chol_kernel import (MAX_LANES, WARP_N_MAX, chol_launch,
                                             chol_smem_bytes)
from lbmpc_tpu_torch.ops import qp_kernel
from lbmpc_tpu_torch.ops.gn_kernel import (NARROW_MAX_LANES, WIDE_MAX_LANES, narrow_gn_launch,
                                           narrow_gn_smem_bytes, wide_launch, wide_smem_bytes,
                                           wide_virtual_warps)
from lbmpc_tpu_torch.ops.qp_kernel import (SHARED_MAX_LANES, SMEM_OPTIN, shared_launch,
                                           shared_smem_bytes)

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


def _narrow_q_max(nz: int) -> int:
    """The largest window one K1 lane holds at nz."""
    q = 1
    while narrow_gn_smem_bytes(nz, q + 1, 1) <= SMEM_OPTIN:
        q += 1
    return q


# ---- K1 (a warp a lane) and K4 (four warps a lane) --------------------------

@pytest.mark.parametrize("nz", [4, 5, 8, 9, 16, 17, 21, 24, 25, 31, 32])
def test_narrow_gn_launch_fits_the_card(nz):
    """K1 at every sampled (nz, q, B): a power of two lanes a block, at most
    NARROW_MAX_LANES, the grid covers B, every SM gets a block where B
    allows, and the block's shared memory is narrow_gn_smem_bytes and
    within the H100's opt-in limit."""
    q_max = _narrow_q_max(nz)
    for q in sorted({1, 2, 7, 100, 101, 500, q_max // 2, q_max}):
        for B in BATCHES:
            lanes, blocks, smem = narrow_gn_launch(nz, q, B, sms=SMS)
            _check_grid(lanes, blocks, B, NARROW_MAX_LANES)
            assert lanes & (lanes - 1) == 0 and blocks >= min(B, SMS)
            assert smem == narrow_gn_smem_bytes(nz, q, lanes) <= SMEM_OPTIN


def test_narrow_gn_launch_at_the_main_shapes():
    """The bench shape (nz=21, q=100): the repair's 24 lanes (and any batch
    up to the SM count) a block each; the bench batch 2048 and the fleet
    cohort 8192 eight lanes a block, 47,232 bytes of shared memory: each
    lane's constants (72 floats), window (800), Jacobian rows (160) and H
    (441), rounded to 4."""
    for B in range(1, SMS + 1):
        assert narrow_gn_launch(21, 100, B, sms=SMS)[:2] == (1, B)
    assert narrow_gn_launch(21, 100, 2048, sms=SMS) == (8, 256, 47232)
    assert narrow_gn_launch(21, 100, 8192, sms=SMS) == (8, 1024, 47232)
    assert narrow_gn_smem_bytes(21, 100, 1) == 4 * (72 + 800 + 160 + 441 + 3)


def test_narrow_gn_launch_rejects_what_the_kernel_does_not_take():
    """nz > 32, N < 3 (nz < 4), an empty window, a negative batch; a window
    too large for one lane says so."""
    for nz, q, B in ((33, 100, 8), (3, 100, 8), (21, 0, 8), (21, 100, -1)):
        with pytest.raises(ValueError):
            narrow_gn_launch(nz, q, B, sms=SMS)
    with pytest.raises(ValueError, match="shared memory"):
        narrow_gn_launch(32, _narrow_q_max(32) + 1, 8, sms=SMS)


@pytest.mark.parametrize("nz", [1, 2, 8, 9, 16, 17, 21, 24, 25, 32])
def test_shared_launch_fits_the_card(nz):
    """K4 at every sampled (mI, nz, B): a power of two lanes a block, at
    most SHARED_MAX_LANES, the grid covers B, every SM gets a block where B
    allows, and the block's shared memory is shared_smem_bytes and within
    the opt-in limit, up to mI = 1024."""
    for mI in (1, 2, 7, 127, 128, 129, 214, 256, 806, 1000, 1023, 1024):
        for B in BATCHES:
            lanes, blocks, smem = shared_launch(mI, nz, B, sms=SMS)
            _check_grid(lanes, blocks, B, SHARED_MAX_LANES)
            assert lanes & (lanes - 1) == 0 and blocks >= min(B, SMS)
            assert smem == shared_smem_bytes(mI, nz, lanes) <= SMEM_OPTIN


def test_shared_launch_at_the_main_shapes():
    """The LMPC QP (mI=806, nz=21): 24 lanes a block each, 1024 and 8192
    four lanes a block (168,128 bytes: G 90 KB at a stride of 28 floats, H,
    and four lanes' x, dx, reciprocal pivots, M, three mI-vectors, the assembly's partials of
    21 blocks over 4 row ranges, G'v's partials and the reduction slots); at
    the domain's corner (mI=1024, nz=32, G 147 KB) two lanes a block."""
    for B in range(1, SMS + 1):
        assert shared_launch(806, 21, B, sms=SMS)[:2] == (1, B)
    assert shared_launch(806, 21, 1024, sms=SMS) == (4, 256, 168128)
    assert shared_launch(806, 21, 8192, sms=SMS) == (4, 2048, 168128)
    lane = 108 + 24 * 25 + 3 * 808 + 4 * 21 * 16 + 8 * 24 + qp_kernel.SHARED_RED
    assert shared_smem_bytes(806, 21, 4) == 4 * (806 * 28 + 600 + 4 * lane)
    assert shared_launch(1024, 32, 8192, sms=SMS)[0] == 2


def test_shared_launch_rejects_what_the_kernel_does_not_take():
    for mI, nz, B in ((806, 0, 8), (806, 33, 8), (0, 21, 8), (1025, 21, 8), (806, 21, -1)):
        with pytest.raises(ValueError):
            shared_launch(mI, nz, B, sms=SMS)


def test_k1_and_k4_host_constants_are_the_kernels():
    """The constants narrow_gn_smem_bytes and shared_smem_bytes size the
    launches by are the sources': K1's lanes a block and gn::lane's working
    memory (the constants before Hconst, D's 5 x 32 floats); K4's lanes a
    block, its group of 128 threads and the assembly's 96, G'v's 8
    partials, the reduction slots."""
    gp, body = _consts("gn_phase.cu"), (CSRC / "gn_body.cuh").read_text()
    assert gp["kMaxLanes"] == NARROW_MAX_LANES
    assert "C_RIDGE = 68, C_HCONST = 72" in body and gn_kernel._C_HCONST == 72
    assert "constexpr int kDFloats = 5 * 32;" in body
    assert "return C_HCONST + 8 * q + kDFloats;" in body
    c4 = _consts("mehrotra.cu")
    assert c4["kMaxLanes"] == SHARED_MAX_LANES
    assert c4["kGroup"] == qp_kernel.SHARED_GROUP and c4["kParts"] == qp_kernel.SHARED_PARTS
    assert c4["kRed"] == qp_kernel.SHARED_RED and c4["kAsm"] == qp_kernel.SHARED_ASM


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
    """csrc/gn_body.cuh reduce_scatter (K1's and K1w's) on v (20, 32): the
    value each lane returns (32,)."""
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
    """csrc/gn_body.cuh rs_lane."""
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


# ---- K1's stage (csrc/gn_body.cuh gn::lane), emulated in float32 ------------

@pytest.mark.parametrize("q", [1, 7, 31, 32, 33, 100, 500])
def test_k1_nw_sums_over_the_point_walk(q):
    """K1's 20 NW sums of a stage: lane l adds the window points l, l + 32,
    ... in order, and the reduce-scatter closes them; read from the lane
    rs_lane names, each equals the 20 full butterflies of the body K1
    replaced, bit for bit. Sums 1..19 sit on 19 distinct lanes, none of
    them sum 0's, so every quotient is divided once (the other lanes divide
    1)."""
    rng = np.random.default_rng(q)
    pts = _scales(rng, (q, 20))
    part = np.zeros((20, 32), np.float32)
    for p in range(q):
        part[:, p % 32] = (part[:, p % 32] + pts[p]).astype(np.float32)
    got = _reduce_scatter(part)
    want = _butterfly(part)[:, 0]
    assert all(got[_rs_lane(i)].tobytes() == want[i].tobytes() for i in range(20))
    owners = [_rs_lane(i) for i in range(1, 20)]
    assert len(set(owners)) == 19 and _rs_lane(0) not in owners


def _walk(E: int, lane: int, step: int = 32):
    """csrc/gn_body.cuh add_rows: the (row, column) entries of the lower
    triangle's first E entries that `lane` updates."""
    tri = lambda i: i * (i + 1) // 2
    i = 0
    while tri(i + 1) <= lane:
        i += 1
    j = lane - tri(i)
    out = []
    for _ in range(lane, E, step):
        out.append((i, j))
        j += step
        while j > i:
            j -= i + 1
            i += 1
    return out


def _rank_update(H, D, entries):
    """H[i, j] += 2 sum_r D[r, i] D[r, j] (from 0 in r order, float32) at
    the given entries."""
    for i, j in entries:
        a = np.float32(0.0)
        for r in range(D.shape[0]):
            a = np.float32(a + np.float32(D[r, i] * D[r, j]))
        H[i, j] = np.float32(H[i, j] + np.float32(2.0) * a)


@pytest.mark.parametrize("N", [3, 20, 31])
def test_k1_causal_h_update_equals_the_full_update(N):
    """At stage k the Jacobian rows D are zero past column k but for theta
    (column N): S_k reaches z_0..z_{k-1}, du_k/dz also z_k. gn::lane updates
    only the lanes' walk over the first tri(k + 1) entries (rows 0..k) and
    row N's columns 0..k and N; the terminal rows update every entry. Over
    a lane's N - 2 stages and the terminal rows this leaves H's lower
    triangle bit for bit what the full rank-5 (then rank-4) update of every
    entry leaves, and each entry is updated by one lane only."""
    rng = np.random.default_rng(N)
    nz = N + 1
    tri = lambda i: i * (i + 1) // 2
    full = np.zeros((nz, nz), np.float32)
    causal = np.zeros((nz, nz), np.float32)
    lower = [(i, j) for i in range(nz) for j in range(i + 1)]
    for k in range(N - 2):
        D = _scales(rng, (5, nz))
        D[:, k + 1:N] = 0.0
        _rank_update(full, D, lower)
        entries = [e for lane in range(32) for e in _walk(tri(k + 1), lane)]
        entries += [(N, c if c <= k else N) for c in range(k + 2)]
        assert len(entries) == len(set(entries))
        _rank_update(causal, D, entries)
    D = _scales(rng, (4, nz))
    _rank_update(full, D, lower)
    entries = [e for lane in range(32) for e in _walk(tri(nz), lane)]
    assert sorted(entries) == sorted(lower)
    _rank_update(causal, D, entries)
    assert full.tobytes() == causal.tobytes()
