"""The launch plan of the port's fused BN->ReLU->1x1-conv kernels
(ops/fused_dense.py:launch_plan) and the 3xTF32 product they compute, on the
CPU.

The plan is plain Python: which block tile each of the three products takes
and how many K chunks share a contraction, from (n, c, f), the card's SM
count and the element size (float32, or bf16 with the backward on a wgmma
core whose K step is 64 deep and whose dW row chunks may form clusters). The kernels themselves run only on a GPU (tests/test_torch_cuda.py);
here the split product is emulated in plain torch (round to TF32's 10
mantissa bits, three products, float32 sums) and held against float64 with
the kernels' tolerances: outputs rtol 1e-5, gradients rtol 1e-4, each with
an atol of 1e-5 times the tensor's largest |value|. bwd_dx's split of F is
held against the JAX kernel in tests/test_torch_fused_dense.py.
"""

import math

import numpy as np
import pytest
import torch

from multimodal_survival_prediction_tpu_torch.ops import fused_dense as fd

SMS = 132  # an H100 SXM
K_STEP, MAX_K, TILE_ROWS = 16, 1024, 64
MAX_CLUSTER = 8  # bwd_dx's F chunks: the portable cluster size
# K steps by element size: (apply's, the backward's); bf16's backward runs
# on the wgmma core, 128 bytes of a row a step
K_STEPS = {4: (K_STEP, K_STEP), 2: (32, 64)}


def _densenet_stages(batch=8, trunk=(16, 16, 8), block_config=(6, 12, 24, 16),
                     growth=32, init=64, bn_size=4):
    """(n, c, f) of every fused stage of DenseNet121-3D in one train step:
    each dense layer's norm1 -> relu -> conv1 and each transition."""
    stages, c = [], init
    n = batch * math.prod(trunk)
    for b, layers in enumerate(block_config):
        for _ in range(layers):
            stages.append((n, c, bn_size * growth))
            c += growth
        if b + 1 < len(block_config):
            stages.append((n, c, c // 2))
            c //= 2
            n //= 8  # the transition's 2x2x2 average pool
    return stages


STAGES = _densenet_stages()
RAGGED = [(5003, 200, 72), (97, 40, 24), (1, 5, 3), (33, 1000, 130)]


def _both_dtypes(shapes):
    """(n, c, f, elem_bytes) cases: float32 under the shape's own id, bf16
    with a "-bf16" suffix."""
    return ([pytest.param(*s, 4, id="-".join(map(str, s))) for s in shapes]
            + [pytest.param(*s, 2, id="-".join(map(str, s)) + "-bf16")
               for s in shapes])


def test_stage_list_is_the_densenet121_train_step():
    assert len(STAGES) == 61 and len(set(STAGES)) == 61
    assert STAGES[0] == (16384, 64, 128) and STAGES[5] == (16384, 224, 128)
    assert STAGES[6] == (16384, 256, 128)      # transition 0
    assert STAGES[19] == (2048, 512, 256)      # transition 1
    assert STAGES[44] == (256, 1024, 512)      # transition 2
    assert STAGES[-1] == (32, 992, 128)


def _apply_blocks(plan, n, f):
    return (math.ceil(n / TILE_ROWS) * math.ceil(f / plan.apply_tile_cols)
            * plan.apply_chunks)


def _chunks(total, per_chunk):
    return [(lo, min(total, lo + per_chunk))
            for lo in range(0, total, per_chunk)]


@pytest.mark.parametrize("n,c,f,elem_bytes", _both_dtypes(STAGES + RAGGED))
def test_plan_chunks_cover_each_contraction_once(n, c, f, elem_bytes):
    """Every K chunk is a whole number of its product's K steps, no chunk is
    empty, the chunks the kernels derive from the plan tile the contraction
    exactly once, and an apply block never contracts more channels than it
    can stage mul/add for. In bf16 every backward tile is 64 wide and dW's
    row chunks form clusters of 1, 2, 4 or 8."""
    plan = fd.launch_plan(n, c, f, SMS, elem_bytes)
    apply_step, bwd_step = K_STEPS[elem_bytes]
    for cols in (plan.apply_tile_cols, plan.dw_tile_cols, plan.dx_tile_cols):
        assert cols in (64, 128)
    if elem_bytes == 2:
        assert plan.dw_tile_cols == plan.dx_tile_cols == 64
        assert plan.dw_cluster in (1, 2, 4, 8)
    else:
        assert plan.dw_cluster == 1
    for total, per_chunk, chunks, step in (
            (c, plan.apply_k_per_chunk, plan.apply_chunks, apply_step),
            (n, plan.dw_rows_per_chunk, plan.dw_chunks, bwd_step),
            (f, plan.da_k_per_chunk, plan.da_chunks, bwd_step),
            (f, plan.dx_k_per_chunk, plan.dx_chunks, bwd_step)):
        assert per_chunk > 0 and per_chunk % step == 0
        assert chunks == math.ceil(total / per_chunk)  # as the launcher counts
        ranges = _chunks(total, per_chunk)
        assert len(ranges) == chunks
        assert ranges[0][0] == 0 and ranges[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(hi > lo for lo, hi in ranges)
    assert plan.apply_k_per_chunk <= MAX_K
    assert plan.dx_chunks <= MAX_CLUSTER


@pytest.mark.parametrize("n,c,f,elem_bytes", _both_dtypes(STAGES + RAGGED))
def test_dx_clusters_take_narrow_tiles_and_fill_no_more_than_the_card(
        n, c, f, elem_bytes):
    """bwd_dx splits F only where its tiles leave SMs idle, so only in 64x64
    tiles (the cluster kernel's), into 2 to 8 chunks (one cluster each), and
    never past one block per SM, so that every cluster is resident at
    once. The same rule holds in bf16, whose tiles are all 64x64."""
    plan = fd.launch_plan(n, c, f, SMS, elem_bytes)
    tiles = math.ceil(n / TILE_ROWS) * math.ceil(c / plan.dx_tile_cols)
    if plan.dx_chunks > 1:
        assert plan.dx_tile_cols == 64 and tiles < SMS
        assert tiles * plan.dx_chunks <= SMS
    else:
        assert plan.dx_k_per_chunk >= f


@pytest.mark.parametrize("n,c,f,elem_bytes", _both_dtypes(STAGES + RAGGED))
def test_scratch_buffers_are_what_the_plan_implies(n, c, f, elem_bytes):
    """The wrappers' buffers hold exactly the partials the kernels write:
    apply's (chunks, n, f) unless one chunk writes the output itself;
    bwd_reduce's dW partials, one per cluster of row chunks (in bf16 none
    where there would be one: the kernel writes dW itself), then
    dbeta/dgamma partials per (64-row tile, F chunk). In bf16 the dW
    partials hold at most a quarter of x's bytes where rows are many (the
    2,048- and 16,384-row stages)."""
    plan = fd.launch_plan(n, c, f, SMS, elem_bytes)
    out, part = fd._apply_buffers(plan, n, f, "cpu")
    assert out.shape == (n, f) and out.dtype == torch.float32
    want = plan.apply_chunks * n * f if plan.apply_chunks > 1 else 0
    assert part.numel() == plan.apply_scratch == want
    out, part = fd._reduce_buffers(plan, c, f, "cpu")
    assert out.numel() == c * f + 2 * c
    row_tiles = math.ceil(n / TILE_ROWS)
    partials = math.ceil(plan.dw_chunks / plan.dw_cluster)
    if elem_bytes == 2 and partials == 1:
        partials = 0
    want = partials * c * f + row_tiles * plan.da_chunks * 2 * c
    assert part.numel() == plan.reduce_scratch == want
    if elem_bytes == 2 and n >= 2048:
        assert partials * c * f * 4 <= n * c * elem_bytes / 4


@pytest.mark.parametrize("n,c,f", [s for s in STAGES if s[0] <= 2048])
def test_small_stages_fill_the_card(n, c, f):
    """The 54 stages whose 64x128 tiles would leave SMs idle put at least 64
    blocks on a 132-SM card for apply (2 to 64 blocks before), and never
    more than the two blocks per SM that are resident at once."""
    plan = fd.launch_plan(n, c, f, SMS)
    blocks = _apply_blocks(plan, n, f)
    assert 64 <= blocks <= 2 * SMS + SMS // 2
    dw_blocks = (math.ceil(c / TILE_ROWS) * math.ceil(f / plan.dw_tile_cols)
                 * plan.dw_chunks)
    assert 32 <= dw_blocks <= 2 * SMS + SMS // 2
    dx_blocks = (math.ceil(n / TILE_ROWS) * math.ceil(c / plan.dx_tile_cols)
                 * plan.dx_chunks)
    assert 64 <= dx_blocks <= 2 * SMS + SMS // 2


@pytest.mark.parametrize("n,c,f", [s for s in STAGES if s[0] == 16384])
def test_large_stages_are_not_split(n, c, f):
    """Block 0's stages fill the card with one 64x128 tile per 64 rows: one
    column tile at F = 128 (x staged once), no channel chunks, no scratch."""
    plan = fd.launch_plan(n, c, f, SMS)
    assert plan.apply_tile_cols == 128 and f == 128
    assert plan.apply_chunks == 1 and plan.apply_scratch == 0
    assert plan.dx_tile_cols == 128 and plan.da_chunks == 1
    assert plan.dx_chunks == 1 and plan.dx_k_per_chunk == f
    assert _apply_blocks(plan, n, f) == n // 64


def test_plan_depends_on_the_sm_count_only_through_the_split():
    """More SMs never mean fewer blocks; a card with few SMs splits less."""
    n, c, f = 256, 992, 128
    few, many = fd.launch_plan(n, c, f, 16), fd.launch_plan(n, c, f, 132)
    assert few.apply_chunks < many.apply_chunks
    assert _apply_blocks(few, n, f) <= _apply_blocks(many, n, f)
    wide = fd.launch_plan(64, 5000, 128, 132)  # wider than one block stages
    assert wide.apply_k_per_chunk <= MAX_K and wide.apply_chunks >= 5


# ---------------------------------------------------------------------------
# The 3xTF32 product
# ---------------------------------------------------------------------------

def test_round_tf32_keeps_ten_mantissa_bits_to_nearest():
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -6, 6, size=4096)).astype(np.float32))
    r = fd.round_tf32_plain(v)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((r - v).abs() <= v.abs() * 2.0 ** -11).all())
    # ties go away from zero, as cvt.rna rounds: 1 + 2^-11 -> 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -1.0 - 2.0 ** -11])
    assert fd.round_tf32_plain(tie).tolist() == [1.0 + 2.0 ** -10,
                                                 -1.0 - 2.0 ** -10]
    assert torch.equal(fd.round_tf32_plain(r), r)


def _within(got, want, rtol):
    got, want = got.double(), want.double()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("n,c,f", [(256, 992, 128), (256, 1024, 512)])
def test_3xtf32_split_holds_the_kernel_tolerances(n, c, f):
    """The split product of the three contractions (apply's a @ W, and the
    backward's a^T g and g W^T) against float64 at the widest path shapes:
    within the kernels' tolerances, where one TF32 product is not."""
    rng = np.random.default_rng(1)
    a = torch.relu(torch.from_numpy(
        rng.normal(0.5, 2.0, (n, c)).astype(np.float32)))
    w = torch.from_numpy(
        (rng.normal(size=(c, f)) * (2.0 / c) ** 0.5).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    for lhs, rhs, rtol in ((a, w, 1e-5), (a.T.contiguous(), g, 1e-4),
                           (g, w.T.contiguous(), 1e-4)):
        exact = lhs.double() @ rhs.double()
        assert _within(fd.matmul_3xtf32_plain(lhs, rhs), exact, rtol)
        single = fd.round_tf32_plain(lhs) @ fd.round_tf32_plain(rhs)
        assert not _within(single, exact, rtol)
