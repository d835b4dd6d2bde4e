"""K2's and K3's launch shape (ops/qp_kernel.narrow_launch): how many lanes
(warps) a block holds, over the kernels' whole domain, on the CPU.

The kernels (csrc/mehrotra_h.cu, csrc/gn_mehrotra.cu) run one lane on one
warp, several lanes a block; the block stages G once and each warp keeps
its own region of shared memory (csrc/mehrotra_warp.cuh). The host picks
the warps a block; these tests hold that choice to the card's limits and to
its rule for small batches. The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import pathlib
import re

import pytest

from lbmpc_tpu_torch.ops import qp_kernel
from lbmpc_tpu_torch.ops.qp_kernel import (NARROW_MAX_WARPS, SMEM_OPTIN, narrow_launch,
                                           narrow_smem_bytes)

SMS = 132
BATCHES = (1, 2, 3, 24, 96, 131, 132, 133, 264, 300, 1000, 1024, 2048, 4095, 8192)
CSRC = pathlib.Path(qp_kernel.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("q", [0, 100])
def test_launch_fits_the_card_over_the_domain(q):
    """Every (nz 1-32, mI 1-1024) at the sampled batches: at least one lane
    and at most NARROW_MAX_WARPS a block, the grid covers B, the block's
    shared memory within the H100's opt-in limit (K3: with its window of q
    points a lane)."""
    for nz in range(1, 33):
        for mI in range(1, 1025):
            for B in BATCHES:
                warps, blocks, smem = narrow_launch(mI, nz, B, q=q, sms=SMS)
                assert 1 <= warps <= NARROW_MAX_WARPS
                assert blocks == -(-B // warps) and blocks * warps >= B > (blocks - 1) * warps
                assert smem == narrow_smem_bytes(mI, nz, warps, q) <= SMEM_OPTIN


@pytest.mark.parametrize("q", [0, 100])
def test_small_batches_get_a_block_a_lane(q):
    """Up to the SM count every lane has its own block (one lane's latency
    is what a small batch sees); above it a block holds the most lanes
    that still leave a block for every SM, as far as shared memory allows."""
    for B in range(1, SMS + 1):
        assert narrow_launch(214, 21, B, q=q, sms=SMS)[:2] == (1, B)
    for B, want in ((SMS + 1, 1), (2 * SMS, 2), (300, 2), (600, 4), (1056, 8), (2048, 8),
                    (8192, 8)):
        assert narrow_launch(214, 21, B, q=q, sms=SMS)[0] == want
    # the repair's K=24 and the fleet block's ~96 lanes: a block each
    assert narrow_launch(214, 21, 24, q=q, sms=SMS) == (1, 24, narrow_smem_bytes(214, 21, 1, q))


def test_shared_memory_sets_the_lanes_at_the_domain_edge():
    """At mI = 1024, nz = 32, G alone is 147 KB in shared memory (rows padded
    to 36 floats) and each lane's region holds its row state: a block holds
    two lanes, not eight, and says so rather than failing."""
    warps, blocks, smem = narrow_launch(1024, 32, 8192, sms=SMS)
    assert warps == 2 and blocks == 4096 and smem <= SMEM_OPTIN
    assert narrow_smem_bytes(1024, 32, 4) > SMEM_OPTIN
    assert narrow_launch(806, 21, 8192, sms=SMS)[0] == 4


def test_launch_rejects_what_the_kernels_do_not_take():
    for mI, nz, B in ((0, 21, 8), (1025, 21, 8), (214, 0, 8), (214, 33, 8), (214, 21, -1)):
        with pytest.raises(ValueError):
            narrow_launch(mI, nz, B, sms=SMS)
    with pytest.raises(ValueError, match="shared memory"):
        narrow_launch(1024, 32, 8, q=4000, sms=SMS)


def test_host_formula_is_the_kernels():
    """The constants narrow_smem_bytes uses are the header's."""
    text = (CSRC / "mehrotra_warp.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kMaxWarps"] == NARROW_MAX_WARPS
    assert const["kVec"] == qp_kernel.NARROW_VEC
    assert const["kRegRowsMax"] == qp_kernel.NARROW_REG_ROWS
    assert const["kStateVecs"] == qp_kernel.NARROW_STATE_VECS
    assert const["kMaxRows"] == qp_kernel.MI_MAX and const["kNzMax"] == qp_kernel.NZ_MAX
    assert "{ return (nz + 7) / 8 * 8; }" in text and "{ return padded_nz(nz) + 4; }" in text
    assert "{ return padded_nz(nz) + 1; }" in text
    for nz in range(1, 33):
        kn, s = qp_kernel.narrow_padded_nz(nz), qp_kernel.narrow_g_stride(nz)
        assert kn % 8 == 0 and nz <= kn < nz + 8 and s >= kn and s % 8 == 4
