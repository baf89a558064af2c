"""Per-kernel parity of the PyTorch port (paddle_tpu_torch) against the JAX
reference.

Each kernel module of the port holds a hand-written CUDA kernel and its
plain PyTorch version; on CPU tensors the port runs the plain version.
The same inputs, made with numpy from a seed, go through:

* the JAX function on its XLA path (the default on the CPU), and
* the JAX Pallas kernel in interpret mode,

and both must agree with the port within 1e-5 abs/rel in f32 — the bar
the reference holds its own fused paths to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core.flags import all_flags, set_flags

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def flags_guard():
    saved = all_flags()
    yield
    set_flags(saved)


def t(a):
    """numpy/jax array -> CPU torch tensor (bf16 via f32, exactly)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy()


# ------------------------------------------------------------ K1 layer norm

@pytest.mark.parametrize("shape", [(13, 48), (3, 5, 40), (1, 64),
                                   (4, 1024), (5, 770)])
def test_layer_norm_matches_jax_xla_and_interpret(rng, flags_guard, shape):
    from paddle_tpu.ops.pallas.layer_norm import (_stats_pallas, _stats_xla,
                                                  layer_norm_fused)
    from paddle_tpu_torch.ops.cuda.layer_norm import (layer_norm_fused as
                                                      port_ln,
                                                      layer_norm_plain)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32) * 3 + 1
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    got = n(port_ln(t(x), t(g), t(b), begin_norm_axis=len(shape) - 1))
    ref_xla = np.asarray(layer_norm_fused(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(b),
                                          begin_norm_axis=len(shape) - 1))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    set_flags({"pallas_interpret": True, "use_pallas_layer_norm": True})
    x2 = x.reshape(-1, c)
    y, m, r = _stats_pallas(jnp.asarray(x2), jnp.asarray(g), jnp.asarray(b),
                            1e-5, interpret=True, block_rows=8)
    py, pm, pr = layer_norm_plain(t(x2), t(g), t(b), 1e-5)
    np.testing.assert_allclose(n(py), np.asarray(y), **TOL)
    np.testing.assert_allclose(n(pm), np.asarray(m), **TOL)
    np.testing.assert_allclose(n(pr), np.asarray(r), **TOL)
    xy, xm, xr = _stats_xla(jnp.asarray(x2), jnp.asarray(g), jnp.asarray(b),
                            1e-5)
    np.testing.assert_allclose(n(pm), np.asarray(xm), **TOL)
    np.testing.assert_allclose(n(pr), np.asarray(xr), **TOL)


# -------------------------------------------------------------- K4 fused MLP

@pytest.mark.parametrize("rows,inter", [(13, 72), (8, 128), (1, 40)])
def test_fused_mlp_matches_jax_xla_and_interpret(rng, flags_guard, rows,
                                                 inter):
    from paddle_tpu.ops.pallas.mlp import _mlp_pallas, fused_mlp
    from paddle_tpu_torch.ops.cuda.mlp import fused_mlp as port_mlp
    h = 32
    x = rng.randn(rows, h).astype(np.float32)
    w1 = (rng.randn(h, inter) * 0.2).astype(np.float32)
    b1 = (rng.randn(inter) * 0.1).astype(np.float32)
    w2 = (rng.randn(inter, h) * 0.2).astype(np.float32)
    b2 = (rng.randn(h) * 0.1).astype(np.float32)
    got = n(port_mlp(t(x), t(w1), t(b1), t(w2), t(b2)))
    ref_xla = np.asarray(fused_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2))))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    set_flags({"pallas_interpret": True, "use_pallas_mlp": True})
    # small tiles: the row tail and the intermediate tail both run
    ref_int = np.asarray(_mlp_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                     None, None, "gelu", interpret=True,
                                     blocks=(8, 32)))
    np.testing.assert_allclose(got, ref_int, **TOL)


@pytest.mark.parametrize("rows,inter,sms", [
    (8, 3072, 132), (32, 3072, 132), (13, 3000, 132), (1, 40, 132),
    (17, 200, 132), (8, 4096, 132), (2048, 100, 132), (8, 3072, 1),
    (8, 30000, 132), (40, 3072, 16)])
def test_mlp_split_plan_covers_every_chunk(rows, inter, sms):
    """The split route's plan: the row tile holds the rows (the largest
    tile past it, in a grid of tiles); the slices cover every I column
    exactly once, in whole 8-column units but the last, none empty; at
    one row tile one slice per SM wherever the units allow, none wider
    than SPLIT_WIDEST; at more, the fewest slices whose blocks reach one
    an SM and one for each SPLIT_WIDEST columns."""
    from paddle_tpu_torch.ops.cuda import mlp
    tile, splits = mlp.split_plan(rows, inter, sms)
    assert tile in mlp.SPLIT_TILES
    assert rows <= tile or tile == mlp.SPLIT_TILES[-1]
    assert all(t < rows for t in mlp.SPLIT_TILES if t < tile)
    slices = mlp.split_slices(inter, splits)
    covered = [i for i0, i1 in slices for i in range(i0, i1)]
    assert covered == list(range(inter))
    units = -(-inter // mlp.SPLIT_UNIT)
    row_tiles = -(-rows // tile)
    for i0, i1 in slices:
        assert i0 % mlp.SPLIT_UNIT == 0 and 0 < i1 - i0
        assert row_tiles > 1 or i1 - i0 <= mlp.SPLIT_WIDEST
        assert (i1 - i0) % mlp.SPLIT_UNIT == 0 or i1 == inter
    if row_tiles == 1:
        assert splits == min(units, max(sms, -(-units // 4)))
    blocks = splits * row_tiles
    assert splits == units or (blocks >= sms and 4 * blocks >= units)
    fewer = (splits - 1) * row_tiles
    assert splits == 1 or fewer < sms or 4 * fewer < units


@pytest.mark.parametrize("rows", [33, 100, 512, 2048, 8192])
@pytest.mark.parametrize("inter", [3004, 3072, 16384])
def test_mlp_split_plan_keeps_the_partials_near_the_output(rows, inter):
    """The split route at many rows (bf16 at widths the tensor cores
    cannot take): the splits fall as the row tiles grow, so the f32
    partials ``[splits, rows, Hout]`` hold, beyond the output's own rows,
    fewer than a row tile for each SM or each SPLIT_WIDEST columns of I;
    8192 rows at GPT's I take one split."""
    from paddle_tpu_torch.ops.cuda import mlp
    sms = 132
    tile, splits = mlp.split_plan(rows, inter, sms)
    units = -(-inter // mlp.SPLIT_UNIT)
    assert (splits - 1) * rows < max(sms, -(-units // 4)) * tile
    if rows == 8192 and inter < 4096:
        assert splits == 1


#: the H100's resident block slots, which the plans read on the card
#: (``core.resident_slots``: 132 SMs x the blocks an SM holds, by the CUDA
#: occupancy calculator): the gemm route's kernel 2 at either tile height,
#: K2's simt kernel 4, 3, 2 and 1 by head dim. The gpu test
#: ``test_resident_slots_are_the_h100s`` holds the card to them.
H100_GEMM_SLOTS = {128: 2 * 132, 64: 2 * 132}
H100_FLASH_SLOTS = {16: 4 * 132, 32: 3 * 132, 64: 2 * 132, 128: 132}


#: (rows, cols, depth) of the gemm route's passes: prefill chunks of 512
#: and 256 rows, generate's 2048-row prefill, the f32 crosschecks, tails
_SIMT_PASSES = [(512, 3072, 768), (512, 768, 3072), (256, 3072, 768),
                (256, 768, 3072), (2048, 3072, 768), (2048, 768, 3072),
                (33, 3000, 768), (33, 768, 3000), (513, 200, 96),
                (100, 40, 64), (8197, 1024, 4096)]


@pytest.mark.parametrize("rows,cols,depth", _SIMT_PASSES)
@pytest.mark.parametrize("split", [False, True])
def test_mlp_simt_gemm_plan_covers_every_tile_once(rows, cols, depth,
                                                   split):
    """A gemm-route pass: BM x 96 tiles of a tile height the kernel has,
    every (row tile, column tile, k tile) in exactly one block, the k
    splits in ascending contiguous ranges (the order the partials are
    summed in), pass 1 never split, and no other choice of the plan's
    costing cheaper."""
    from paddle_tpu_torch.ops.cuda import mlp
    slots = H100_GEMM_SLOTS
    bm, splits, blocks = mlp.simt_gemm_plan(rows, cols, depth, slots, split)
    assert bm in mlp.SIMT_ROWS
    assert 1 <= splits <= (mlp.SIMT_MAX_SPLITS if split else 1)
    mt, nt = -(-rows // bm), -(-cols // mlp.SIMT_COLS)
    kts = -(-depth // mlp.SIMT_BK)
    assert blocks == mt * nt * splits
    ranges = mlp.simt_k_ranges(depth, splits)
    assert [k for k0, k1 in ranges for k in range(k0, k1)] == list(
        range(kts))
    assert all(k1 > k0 for k0, k1 in ranges)
    walked = sorted((m, n_, k) for m in range(mt) for n_ in range(nt)
                    for k0, k1 in ranges for k in range(k0, k1))
    assert len(walked) == len(set(walked)) == mt * nt * kts

    def cost(bm_, s_):
        b_ = -(-rows // bm_) * nt * s_
        return (-(-b_ // slots[bm_]) * bm_
                * -(-kts // s_) / mlp.simt_issue_share(bm_))
    assert all(cost(bm, splits) <= cost(b_, s_) for b_ in mlp.SIMT_ROWS
               for s_ in range(1, (min(mlp.SIMT_MAX_SPLITS, kts)
                                   if split else 1) + 1))


def test_mlp_simt_plans_at_the_serving_shapes():
    """At GPTConfig.small()'s widths on 132 SMs (two blocks an SM): a
    512-row prefill chunk runs pass 1 as 256 tiles of 64 x 96 and pass 2
    as 32 tiles of 128 x 96 split 8 ways (256 blocks), the choices the
    H100 read fastest among every tile height and split (PERF.md); a
    256-row chunk pass 1 as 128 tiles of 64 x 96, pass 2 as 32 of them
    split 8 ways; generate's 2048 rows split pass 2 in two; decode's 8
    rows and verify's 32 take the split route at one slice per SM."""
    from paddle_tpu_torch.ops.cuda import mlp
    slots = H100_GEMM_SLOTS
    assert mlp.simt_gemm_plan(512, 3072, 768, slots) == (64, 1, 256)
    assert mlp.simt_gemm_plan(512, 768, 3072, slots, True) == (128, 8, 256)
    assert mlp.simt_gemm_plan(256, 3072, 768, slots) == (64, 1, 128)
    assert mlp.simt_gemm_plan(256, 768, 3072, slots, True) == (64, 8, 256)
    assert mlp.simt_gemm_plan(2048, 3072, 768, slots) == (128, 1, 512)
    assert mlp.simt_gemm_plan(2048, 768, 3072, slots, True) == (128, 2,
                                                                256)
    assert mlp.split_plan(8, 3072, 132) == (8, 132)
    assert mlp.split_plan(32, 3072, 132) == (32, 132)


@pytest.mark.parametrize("dtype,rows,route", [
    (torch.float32, 1, "split"), (torch.float32, 8, "split"),
    (torch.float32, 32, "split"), (torch.float32, 33, "gemm"),
    (torch.float32, 256, "gemm"), (torch.float32, 512, "gemm"),
    (torch.float32, 2048, "gemm"), (torch.bfloat16, 8, "tc"),
    (torch.bfloat16, 512, "tc")])
def test_mlp_route_rule_by_rows(dtype, rows, route):
    """K4's route at GPTConfig.small()'s widths: f32 takes the split
    route up to SPLIT_ROWS rows (decode 8, verify 32) and the gemm route
    past them (prefill chunks of 256 and 512, generate's 2048); bf16
    takes the tensor cores at any rows."""
    from paddle_tpu_torch.ops.cuda import mlp
    assert mlp.mlp_route(dtype, 768, 3072, 768, rows) == route


def _split_mlp_plain(x, w1, b1, w2, b2, splits, fault=None):
    """The split route's algorithm in plain torch (``csrc/mlp_simt.cu``
    split::): each split's I slice, its gelu activation and its partial
    of the output; the partials summed as split_merge_kernel sums them
    (eight fixed groups, then the groups in order), plus b2. ``fault``
    plants one of the faults the card check must catch: ``"drop_b1"``
    (split 1 leaves out b1), ``"row_shift"`` (each row's partial written
    one row down), ``"twice"`` (split 0's partial summed twice)."""
    from paddle_tpu_torch.ops.activations import gelu
    from paddle_tpu_torch.ops.cuda import mlp
    parts = []
    for s_, (i0, i1) in enumerate(mlp.split_slices(w1.shape[1], splits)):
        # a block's slice, SPLIT_WIDEST columns at a time, in order
        p = 0
        for c0 in range(i0, i1, mlp.SPLIT_WIDEST):
            c1 = min(i1, c0 + mlp.SPLIT_WIDEST)
            h = x @ w1[:, c0:c1]
            if not (fault == "drop_b1" and s_ == 1):
                h = h + b1[c0:c1]
            p = p + gelu(h) @ w2[c0:c1]
        if fault == "row_shift":
            p = torch.cat([p[:1] * 0, p[:-1]])
        parts.append(p)
    if fault == "twice":
        parts.append(parts[0])
    groups = [sum(parts[g::8], torch.zeros_like(parts[0]))
              for g in range(8)]
    return sum(groups, torch.zeros_like(parts[0])) + b2


def _gemm_mlp_plain(x, w1, b1, w2, b2, splits, fault=None):
    """The gemm route's algorithm in plain torch: pass 1's activation,
    pass 2's partials over the k ranges ``simt_k_ranges`` gives, summed
    in split order with b2. ``fault``: ``"drop_b1"`` (pass 1's second
    column tile without b1), ``"row_shift"`` (pass 2 stores each row one
    row down), ``"twice"`` (split 0's partial summed twice)."""
    from paddle_tpu_torch.ops.activations import gelu
    from paddle_tpu_torch.ops.cuda import mlp
    bias = b1.clone()
    if fault == "drop_b1":
        bias[mlp.SIMT_COLS:2 * mlp.SIMT_COLS] = 0
    act = gelu(x @ w1 + bias)
    parts = [act[:, k0 * mlp.SIMT_BK:k1 * mlp.SIMT_BK]
             @ w2[k0 * mlp.SIMT_BK:k1 * mlp.SIMT_BK]
             for k0, k1 in mlp.simt_k_ranges(w1.shape[1], splits)]
    if fault == "twice":
        parts.append(parts[0])
    out = sum(parts, torch.zeros_like(parts[0])) + b2
    if fault == "row_shift":
        out = torch.cat([out[:1] * 0, out[:-1]])
    return out


@pytest.mark.parametrize("route,rows,inter,splits", [
    ("split", 8, 200, 25), ("split", 13, 3000, 132), ("split", 32, 72, 9),
    ("split", 100, 3000, 3),
    ("gemm", 40, 200, 3), ("gemm", 130, 3000, 8), ("gemm", 33, 72, 1)])
def test_mlp_simt_algorithms_match_jax(rng, route, rows, inter, splits):
    """The split and gemm routes' split-and-sum, in plain torch, against
    the JAX fused MLP (XLA path) at 1e-5: ragged I slices and k ranges,
    I not a multiple of the unit or of 16. W2 is drawn at I^-0.5, so
    outputs are of order 1 at every I."""
    from paddle_tpu.ops.pallas.mlp import fused_mlp
    h = 48
    x = rng.randn(rows, h).astype(np.float32)
    w1 = (rng.randn(h, inter) * 0.2).astype(np.float32)
    b1 = (rng.randn(inter) * 0.1).astype(np.float32)
    w2 = (rng.randn(inter, h) * inter ** -0.5).astype(np.float32)
    b2 = (rng.randn(h) * 0.1).astype(np.float32)
    fn = _split_mlp_plain if route == "split" else _gemm_mlp_plain
    got = n(fn(t(x), t(w1), t(b1), t(w2), t(b2), splits))
    ref = np.asarray(fused_mlp(*map(jnp.asarray, (x, w1, b1, w2, b2))))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("route", ["split", "gemm"])
@pytest.mark.parametrize("fault", ["none", "drop_b1", "row_shift", "twice"])
def test_mlp_card_check_fails_each_planted_fault(route, fault):
    """chip_smoke.py's K4 check (max |kernel - plain| <= F32_TOL) on the
    CPU at its serving shapes (8 rows on the split route, 132 slices; 512
    rows on the gemm route, pass 2 split 4 ways), with its inputs: the
    routes' split-and-sum passes it, and each planted fault fails it."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import mlp
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    rows, splits = (8, 132) if route == "split" else (512, 4)
    x = randn(rows, 768)
    w1, b1 = randn(768, 3072, scale=0.036), randn(3072, scale=0.02)
    w2, b2 = randn(3072, 768, scale=0.036), randn(768, scale=0.02)
    fn = _split_mlp_plain if route == "split" else _gemm_mlp_plain
    got = fn(x, w1, b1, w2, b2, splits, None if fault == "none" else fault)
    err = chip_smoke.max_err(got, mlp.mlp_plain(x, w1, b1, w2, b2))
    if fault == "none":
        chip_smoke.check("mlp", err, chip_smoke.F32_TOL)
        return
    with pytest.raises(AssertionError):
        chip_smoke.check(f"mlp {fault}", err, chip_smoke.F32_TOL)


# ----------------------------------------- K4 / K5 tensor-core route plans

#: (rows, cols) of the tc passes: GPT train (8192 rows), BERT (32768),
#: BERT-large (4096 rows, H = 1024, I = 4096), and ragged rows and widths
_MLP_PASSES = [(8192, 3072), (8192, 768), (32768, 3072), (32768, 768),
               (4096, 4096), (4096, 1024), (1, 768), (13, 3000),
               (13, 768), (8197, 3072), (8197, 1024), (8197, 3000)]


def _persistent_items(items, grid):
    """The work items each block walks: ``blockIdx.x``, ``+ gridDim.x``,
    ... (``csrc/gemm.cuh``)."""
    return [list(range(b, items, grid)) for b in range(grid)]


@pytest.mark.parametrize("rows,cols", _MLP_PASSES)
def test_mlp_tc_plan_covers_every_tile_once(rows, cols):
    """One tc pass's plan: 128-row tiles of a width the kernel has, every
    output tile in exactly one block's walk, at most one block per SM, and
    the waves' SM slots kept busy as the rule promises: at least
    ``TC_BUSY`` (two waves at least 3/4 full) unless no width reaches
    it, and then the busiest width."""
    from paddle_tpu_torch.ops.cuda import core, mlp
    sms = 132
    width, tiles, grid = mlp.gemm_plan(rows, cols, sms)
    assert width in mlp.TC_WIDTHS
    mt, nt = -(-rows // mlp.TC_ROWS), -(-cols // width)
    assert tiles == mt * nt and 1 <= grid <= min(tiles, sms)
    # item it -> (row tile it // nt, column tile it % nt), as item_of
    walked = sorted((it // nt, it % nt)
                    for items in _persistent_items(tiles, grid)
                    for it in items)
    assert walked == [(m, n) for m in range(mt) for n in range(nt)]
    assert (nt - 1) * width < cols <= nt * width
    busy = core.wave_busy(tiles, sms)
    others = [core.wave_busy(mt * -(-cols // w), sms)
              for w in mlp.TC_WIDTHS]
    if busy < mlp.TC_BUSY:
        assert all(b < mlp.TC_BUSY for b in others) and busy == max(others)
    else:
        wider = [w for w in mlp.TC_WIDTHS if w > width]
        assert all(core.wave_busy(mt * -(-cols // w), sms) < mlp.TC_BUSY
                   for w in wider)
    if -(-tiles // sms) == 2 and busy >= mlp.TC_BUSY:
        assert tiles / sms - 1 >= 0.75          # the last wave 3/4 full


def test_mlp_tc_plan_widths_of_the_training_paths():
    """The widths the plan picks at the training paths' shapes: GPT's
    pass 2 (8192 x 768) would be 1.45 waves at 256 columns, so it takes
    192 (1.94 waves); every other pass keeps 256."""
    from paddle_tpu_torch.ops.cuda import mlp
    assert mlp.gemm_plan(8192, 768, 132)[0] == 192
    for rows, cols in ((8192, 3072), (32768, 3072), (32768, 768),
                       (4096, 4096), (4096, 1024)):
        assert mlp.gemm_plan(rows, cols, 132)[0] == 256


@pytest.mark.parametrize("n,v", [(8176, 32000), (4864, 30522),
                                 (1, 30522), (13, 300), (8197, 32000),
                                 (130, 256), (4864, 65)])
def test_xent_stats_tc_plan_covers_every_tile_once(n, v):
    """K5's tc plan: the vocab's 256-column tiles cut into splits that
    cover them exactly once, every (row tile, vocab tile) in exactly one
    block's walk, at most one block per SM, and the busy rule kept with
    the fewest splits."""
    from paddle_tpu_torch.ops.cuda import core, xent
    sms = 132
    splits, per, grid = xent.stats_tc_plan(n, v, sms)
    mt = -(-n // xent.STATS_TC_ROWS)
    tiles = -(-v // xent.STATS_TC_WIDTH)
    assert 1 <= splits <= xent.STATS_TC_MAX_SPLITS
    assert (splits - 1) * per < tiles <= splits * per
    items = mt * splits
    assert 1 <= grid <= min(items, sms)
    walked = sorted((it // splits, c)
                    for its in _persistent_items(items, grid)
                    for it in its
                    for c in range((it % splits) * per,
                                   min(tiles, (it % splits + 1) * per)))
    assert walked == [(m, c) for m in range(mt) for c in range(tiles)]
    busy = core.wave_busy(items, sms)
    fewer = [core.wave_busy(mt * -(-tiles // -(-tiles // s)), sms)
             for s in range(1, splits)]
    assert all(b < xent.STATS_TC_BUSY for b in fewer)
    if busy < xent.STATS_TC_BUSY:
        assert all(b <= busy for b in fewer)


@pytest.mark.parametrize("dtype,widths,route,k5_route", [
    (torch.bfloat16, (768, 3072, 768), "tc", "tc"),
    (torch.bfloat16, (1024, 4096, 1024), "tc", "tc"),
    (torch.bfloat16, (96, 200, 96), "tc", "tc"),
    (torch.bfloat16, (100, 3072, 100), "split", "simt"),
    (torch.bfloat16, (768, 3004, 768), "split", "tc"),
    (torch.bfloat16, (768, 3072, 100), "split", "tc"),
    (torch.float32, (768, 3072, 768), "split", "tf32x3"),
])
def test_k4_k5_route_rule(dtype, widths, route, k5_route):
    """K4's and K5's route: bf16 with every width a multiple of 8 (whole
    16-byte TMA rows; K4 has H, I and Hout, K5 only H) takes the tensor
    cores; any other width in bf16 K4's split route and K5's SIMT
    kernel; f32 at 8 rows K4's split route (the gemm route takes f32
    past 32 rows: test_mlp_route_rule_by_rows) and K5's 3xTF32 route
    (H % 4 == 0: test_xent_route_rule)."""
    from paddle_tpu_torch.ops.cuda import mlp, xent
    assert mlp.mlp_route(dtype, *widths, 8) == route
    assert xent.stats_route(dtype, widths[0]) == k5_route


def test_tc_gelu_fit_is_erf_to_f32_precision():
    """The tc route's branch-free gelu (``csrc/mlp.cu gelu_fit``):
    erfc(u / sqrt 2) = 2^(u Q(u)) with Q read from the source, evaluated
    in f32 like the kernel, against the exact erf gelu in float64."""
    import os
    import re

    from scipy.special import erfc
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "paddle_tpu_torch/csrc/mlp.cu")) as f:
        src = f.read()
    body = src[src.index("float gelu_fit(float x)"):]
    body = body[:body.index("\n}")]
    head = re.search(r"float q = ([-+0-9.e]+)f;", body).group(1)
    tail = re.findall(r"q = fmaf\(q, u, ([-+0-9.e]+)f\);", body)
    coef = [np.float32(c) for c in [head] + tail]
    assert len(coef) == 11
    x = np.linspace(-9.0, 9.0, 360001).astype(np.float32)
    u = np.minimum(np.abs(x), np.float32(6.5))
    q = coef[0]
    for c in coef[1:]:
        q = (q * u + c).astype(np.float32)
    e = np.exp2((q * u).astype(np.float32)).astype(np.float64)
    x64 = x.astype(np.float64)
    ref_e = erfc(np.abs(x64) / np.sqrt(2.0))
    assert np.abs(e - ref_e).max() <= 2.5e-7
    got = 0.5 * x64 * np.where(x64 >= 0, 2.0 - e, e)
    want = 0.5 * x64 * erfc(-x64 / np.sqrt(2.0))
    assert np.abs(got - want).max() <= 2.5e-7 * 9.0
    assert (np.abs(got - want) <= 2.5e-7 * np.maximum(1.0, np.abs(x64))
            ).all()


def _wave_fill(blocks, sms):
    """The share of the last wave's SMs that have a block (one per SM)."""
    return blocks / sms - (-(-blocks // sms) - 1)


def _covers_in_whole_waves(units, tiles, splits, per, sms, max_splits):
    """A split plan of ``tiles`` streamed tiles under ``units`` blocks:
    each tile in exactly one split; the last wave at least half full
    unless no split within ``max_splits`` makes it fuller."""
    covered = [t_ for s_ in range(splits)
               for t_ in range(s_ * per, min(tiles, (s_ + 1) * per))]
    assert covered == list(range(tiles))
    assert (splits - 1) * per < tiles
    blocks = units * splits
    waves = -(-blocks // sms)
    assert (waves - 1) * sms < blocks <= waves * sms
    if _wave_fill(blocks, sms) < 0.5:
        for want in range(1, min(max_splits, tiles) + 1):
            per_ = -(-tiles // want)
            fill = _wave_fill(units * -(-tiles // per_), sms)
            assert fill <= _wave_fill(blocks, sms) < 0.5


@pytest.mark.parametrize("hid", [64, 96, 640, 768, 1024])
def test_xent_bwd_plan_covers_every_tile_in_whole_waves(hid):
    """K6's launch plans, bf16 and f32: every (resident tile, column
    chunk, streamed tile) is covered exactly once; all waves but the last
    are full (one block per SM) and the last is at least half full
    wherever a split of the streamed axis can make it so; shared memory
    stays within the H100's 227 KB per block."""
    from paddle_tpu_torch.ops.cuda import core, xent
    sms = 132
    shapes = ((8176, 32000), (4864, 30522), (37, 65), (1000, 5000),
              (300, 2000), (130, 1000))        # GPT, BERT(-large), ragged
    for n_, v in shapes:
        for res, streamed in ((n_, v), (v, n_)):   # dh, then dw/db
            plan = xent.tc_plan(res, streamed, hid, sms)
            assert plan["smem"] <= core.MAX_SMEM
            boxes, width = -(-hid // 64), 2 * plan["slots"]
            assert plan["slots"] <= xent.TC_MAX_SLOTS
            assert (plan["chunks"] - 1) * width < boxes
            assert boxes <= plan["chunks"] * width
            assert 2 * plan["stages"] >= min(boxes, width)
            _covers_in_whole_waves(
                -(-res // xent.TC_ROWS) * plan["chunks"],
                -(-streamed // xent.TC_BOX), plan["splits"], plan["per"],
                sms, xent.MAX_SPLITS)
            simt = xent.simt_plan(res, streamed, hid, sms)
            assert simt["smem"] <= core.MAX_SMEM
            assert (simt["chunks"] - 1) * xent.SIMT_COLS < hid
            assert hid <= simt["chunks"] * xent.SIMT_COLS
            _covers_in_whole_waves(
                -(-res // xent.RES_ROWS) * simt["chunks"],
                -(-streamed // xent.STREAM_ROWS), simt["splits"],
                simt["per"], sms, xent.MAX_SPLITS)
        assert xent.stats_smem(hid) <= core.MAX_SMEM
    # the training paths' shapes fill their last wave at least half
    for res, streamed in ((8176, 32000), (32000, 8176), (4864, 30522),
                          (30522, 4864)):
        plan = xent.tc_plan(res, streamed, hid, sms)
        blocks = -(-res // 64) * plan["chunks"] * plan["splits"]
        assert _wave_fill(blocks, sms) >= 0.5


@pytest.mark.parametrize("dtype,hid,k5,k6", [
    (torch.bfloat16, 768, "tc", "tc"),
    (torch.bfloat16, 100, "simt", "tc"),
    (torch.float32, 768, "tf32x3", "tf32x3"),
    (torch.float32, 96, "tf32x3", "tf32x3"),
    (torch.float32, 100, "tf32x3", "tf32x3"),
    (torch.float32, 66, "simt", "simt"),
    (torch.float32, 770, "simt", "simt"),
])
def test_xent_route_rule(dtype, hid, k5, k6):
    """K5's and K6's routes: f32 with H % 4 == 0 (whole 16-byte TMA rows)
    takes 3xTF32, f32 with any other H the SIMT kernels; bf16 K5 the
    tensor cores for H % 8 == 0, else SIMT, and bf16 K6 always the tensor
    cores (its plan refuses H % 8 != 0)."""
    from paddle_tpu_torch.ops.cuda import xent
    assert xent.stats_route(dtype, hid) == k5
    assert xent.bwd_route(dtype, hid) == k6


@pytest.mark.parametrize("hid", [64, 96, 576, 768, 1024])
def test_xent_x3_plan_covers_every_tile_in_whole_waves(hid):
    """K6's 3xTF32 plan: H in chunks of 256 columns (the blocks of one
    cluster), every (resident tile of 128, chunk, streamed tile of 64)
    covered exactly once; the last
    wave at least half full wherever a split of the streamed axis can
    make it so, with the fewest splits that do; one fixed shared-memory
    size within the H100's 227 KB per block."""
    from paddle_tpu_torch.ops.cuda import core, xent
    sms = 132
    shapes = ((8176, 32000), (4088, 32000), (4864, 30522), (37, 65),
              (37, 300), (130, 1000))
    for n_, v in shapes:
        for res, streamed in ((n_, v), (v, n_)):   # dh, then dw/db
            plan = xent.x3_plan(res, streamed, hid, sms)
            assert plan["smem"] == xent.x3_smem() <= core.MAX_SMEM
            assert plan["stages"] == xent.X3_STAGES
            assert (plan["chunks"] - 1) * xent.X3_COLS < hid
            assert hid <= plan["chunks"] * xent.X3_COLS
            units = -(-res // xent.X3_ROWS) * plan["chunks"]
            tiles = -(-streamed // xent.X3_STREAM)
            _covers_in_whole_waves(units, tiles, plan["splits"],
                                   plan["per"], sms, xent.MAX_SPLITS)
            for want in range(1, plan["splits"]):
                fewer = -(-tiles // -(-tiles // want))
                if fewer < plan["splits"]:
                    assert _wave_fill(units * fewer, sms) < 0.5
    # the program path's and GPT training's f32 shapes: last wave half full
    for res, streamed in ((4088, 32000), (32000, 4088), (8176, 32000),
                          (32000, 8176)):
        plan = xent.x3_plan(res, streamed, hid, sms)
        blocks = -(-res // xent.X3_ROWS) * plan["chunks"] * plan["splits"]
        assert _wave_fill(blocks, sms) >= 0.5


def test_xent_x3_plan_refuses_what_the_tf32x3_route_cannot_take(
        monkeypatch):
    from paddle_tpu_torch.ops.cuda import core, xent
    with pytest.raises(ValueError, match="multiple of 4"):
        xent.x3_plan(100, 200, 66, 132)
    assert xent.x3_plan(100, 200, 2048, 132)["chunks"] == 8
    with pytest.raises(ValueError, match="cluster"):
        xent.x3_plan(100, 200, 2052, 132)
    monkeypatch.setattr(core, "MAX_SMEM", xent.x3_smem() - 1)
    with pytest.raises(ValueError, match="shared memory"):
        xent.x3_plan(100, 200, 64, 132)


def _tf32(x):
    """f32 -> tf32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, at 10 mantissa bits (the low 13 bits 0), on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_mm(a, b, terms):
    """``a @ b`` in f32 as the tensor cores do it from tf32 operands: one
    product of the rounded operands (1xTF32), or the split ``a = ah +
    al``, ``b = bh + bl`` (hi = tf32(x), lo = tf32(x - hi)) and al bh +
    ah bl + ah bh (3xTF32, csrc/hopper.cuh)."""
    if terms == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_xent_tf32x3_emulation_holds_f32_tol_and_1xtf32_does_not():
    """K5's and K6's f32 products emulated bit for bit as their 3xTF32
    routes round (the split of each operand, three products, f32 sums)
    on [130, 768]·[1000, 768]ᵀ logits: every output (m, s, picked,
    sum_logits; dh, dw, db) within F32_TOL (1e-4, chip_smoke.py's f32
    bar) of float64 on its own scale. 1xTF32 (the rounded operands, one
    product) misses it: so the card's check at F32_TOL tells a dropped
    correction term."""
    f32_tol = 1e-4
    rs = np.random.RandomState(23)
    n_, v, hid = 130, 1000, 768
    h = torch.from_numpy(rs.randn(n_, hid).astype(np.float32))
    w = torch.from_numpy((rs.randn(v, hid) * 0.05).astype(np.float32))
    b = torch.from_numpy((rs.randn(v) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, v, n_))
    labels[::7] = v + 3
    g = torch.from_numpy((rs.randn(n_) * 0.01).astype(np.float32))
    hit = torch.arange(v)[None, :] == labels[:, None]

    def outputs(logits, mm, dt):
        m = logits.max(1).values
        s = torch.exp(logits - m[:, None]).sum(1)
        picked = torch.where(hit, logits, torch.zeros_like(logits)).sum(1)
        logz = (m + torch.log(s)).to(dt)
        gch = ((torch.exp(logits.to(dt) - logz[:, None]) - hit.to(dt))
               * g.to(dt)[:, None])
        return dict(m=m, s=s, picked=picked, sum_logits=logits.sum(1),
                    dh=mm(gch, w.to(dt)), dw=mm(gch.T, h.to(dt)),
                    db=gch.sum(0))

    want = outputs(h.double() @ w.double().T + b.double(),
                   lambda a, c: a @ c, torch.float64)
    rel = {}
    for terms in (3, 1):
        logits = _tf32_mm(h, w.T, terms) + b
        got = outputs(logits.double(),
                      lambda a, c: _tf32_mm(a, c, terms), torch.float32)
        rel[terms] = {k: float((got[k].double() - want[k]).abs().max()
                               / want[k].abs().max()) for k in want}
    assert max(rel[3].values()) <= f32_tol, rel[3]
    assert rel[1]["dh"] > f32_tol and rel[1]["dw"] > f32_tol, rel[1]
    # the split as the kernels make it: hi has 13 zero bits, and hi + lo
    # is x within 2^-22 |x|
    x = h.reshape(-1)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()


def test_xent_bwd_plan_refuses_what_the_bf16_route_cannot_take():
    from paddle_tpu_torch.ops.cuda import xent
    with pytest.raises(ValueError, match="multiple of 8"):
        xent.tc_plan(100, 200, 100, 132)
    with pytest.raises(ValueError, match="shared memory"):
        xent.tc_plan(100, 200, 1216, 132)
    assert xent.tc_plan(100, 200, 1152, 132)["chunks"] == 3


def test_gelu_is_exact_erf(rng):
    from paddle_tpu.ops.activations import gelu
    from paddle_tpu_torch.ops.activations import gelu as port_gelu
    x = rng.randn(257).astype(np.float32) * 4
    np.testing.assert_allclose(n(port_gelu(t(x))),
                               np.asarray(gelu(jnp.asarray(x))), **TOL)


# ------------------------------------------------------- K2 flash attention

@pytest.mark.parametrize("tq,tk,causal,masked", [
    (24, 40, True, False),     # bottom-right causal offset tk - tq
    (40, 40, True, False),
    (24, 24, False, True),     # key padding, one fully masked batch row
])
def test_flash_matches_jax_xla_and_interpret(rng, flags_guard, tq, tk,
                                             causal, masked):
    from paddle_tpu.ops.pallas.flash_attention import (
        _flash_attention_fwd_tpu, chunked_attention)
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        chunked_attention as port_chunked, flash_attention as port_flash)
    b, h, d = 2, 3, 64
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, tk), bool)
        mask[0, tk // 2:] = False
        mask[1] = False
    scale = 1.0 / 8.0
    got, lse = port_chunked(t(q), t(k), t(v), scale, causal,
                            None if mask is None else t(mask),
                            chunk_size=16, return_lse=True)
    got = n(got)
    ref_xla = np.asarray(chunked_attention(
        *map(jnp.asarray, (q, k, v)), scale=scale, causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask), chunk_size=16))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    out, ref_lse = _flash_attention_fwd_tpu(
        *map(jnp.asarray, (q, k, v)), scale, causal, 8, 16,
        kv_mask=None if mask is None else jnp.asarray(mask),
        interpret=True, return_lse=True)
    np.testing.assert_allclose(got, np.asarray(out), **TOL)
    if not masked:
        np.testing.assert_allclose(n(lse), np.asarray(ref_lse), **TOL)
    else:
        assert float(np.abs(got[1]).max()) == 0.0   # fully masked -> 0
    # the dispatching entry takes the plain version on CPU tensors
    entry = port_flash(t(q), t(k), t(v), scale=scale, causal=causal,
                       kv_mask=None if mask is None else t(mask))
    np.testing.assert_allclose(n(entry), got, **TOL)


@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (12, 512, 512, 64, True), (192, 512, 512, 64, True),
    (6, 200, 200, 64, True), (4, 100, 300, 32, True),
    (4, 300, 100, 128, True), (4, 130, 130, 128, False),
    (2, 70, 70, 16, True), (1, 1, 1, 64, True), (24, 4096, 4096, 64, True),
    (3, 65, 1000, 64, False), (12, 64, 65472, 64, False),
    (12, 64, 70000, 64, False)])
def test_flash_plan_covers_every_tile_once_longest_first(bh, tq, tk, d,
                                                         causal):
    """K2's simt work split: every (query tile, kv tile) that the causal
    skip keeps in exactly one item, items in contiguous chunks of at most
    ``chunk`` tiles that start on multiples of it, a query tile without
    a kv tile as one empty item, the list longest first and within the
    kernel's table; no split where the chunk covers every tile, and the
    chunk no longer than the kv tiles over the SMs' block slots."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    tiles = fa.flash_kv_tiles(tq, tk, causal)
    nq, nk = -(-tq // 64), -(-tk // 64)
    assert len(tiles) == nq and all(0 <= x <= nk for x in tiles)
    for qi, x in enumerate(tiles):        # the causal skip: nothing lost
        rows = range(qi * 64, min(tq, qi * 64 + 64))
        need = max((i + tk - tq for i in rows), default=-1) if causal \
            else tk - 1
        assert x == (0 if need < 0 else min(nk, need // 64 + 1))
    slots = H100_FLASH_SLOTS[d]
    chunk, items = fa.flash_plan(bh, tq, tk, causal, slots)
    if items is None:
        assert (chunk >= max(tiles) or nq > fa.FLASH_MAX_ITEMS
                or nk > fa.FLASH_CODE_KV_TILES)
        return
    assert len(items) <= fa.FLASH_MAX_ITEMS
    assert chunk < max(tiles)
    assert chunk == -(-bh * sum(max(1, x) for x in tiles) // slots)
    lengths = [t1 - t0 for _, t0, t1 in items]
    assert lengths == sorted(lengths, reverse=True)
    walked = sorted((qi, t) for qi, t0, t1 in items for t in range(t0, t1))
    assert walked == [(qi, t) for qi, x in enumerate(tiles)
                      for t in range(x)]
    for qi, t0, t1 in items:
        assert t0 % chunk == 0 and t1 - t0 <= chunk
        assert t1 == min(tiles[qi], t0 + chunk)
    assert sorted(qi for qi, t0, t1 in items if t1 == t0) == [
        qi for qi, x in enumerate(tiles) if x == 0]


@pytest.mark.parametrize("bh,tq,tk", [
    (12, 64, 70000), (12, 64, 65472), (12, 64, 65473), (1, 300, 20000),
    (12, 512, 512)])
def test_flash_plan_items_fit_their_code(bh, tq, tk):
    """Every item of a split plan comes back from its code as the kernel
    decodes it (query tile = code >> 20, kv tiles = 10 bits each); past
    1023 kv tiles (Tk > 65,472 keys) the plan does not split, and a code
    that cannot hold its tiles raises instead of wrapping."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    chunk, items = fa.flash_plan(bh, tq, tk, False, H100_FLASH_SLOTS[64])
    nk = -(-tk // 64)
    assert (items is None) == (nk > fa.FLASH_CODE_KV_TILES)
    for qi, t0, t1 in items or ():
        e = fa.flash_item_code(qi, t0, t1)
        assert (e >> 20, (e >> 10) & 1023, e & 1023) == (qi, t0, t1)
    with pytest.raises(ValueError):
        fa.flash_item_code(0, 50, 1024)
    with pytest.raises(ValueError):
        fa.flash_item_code(4096, 0, 1)


def _flash_items_plain(q, k, v, scale, causal, mask, chunk, items,
                       fault=None):
    """K2's simt algorithm in plain torch (``csrc/flash_attention.cu``):
    each item's (m, l, acc) over its kv tiles, written as out and lse
    where its query tile is one item, else merged in chunk order as
    fa_merge_kernel merges them. ``fault`` plants one of the faults the
    card check must catch: ``"lse_row"`` (each row's lse read from the
    next row's), ``"diag"`` (causal ``>`` for ``>=``)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    b, h, tq, d = q.shape
    tk = k.shape[2]
    tiles = fa.flash_kv_tiles(tq, tk, causal)
    if items is None:
        items = [(qi, 0, x) for qi, x in reversed(list(enumerate(tiles)))]
    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, tq)
    parts = {}
    for qi, t0, t1 in items:
        r0, r1 = qi * 64, min(tq, qi * 64 + 64)
        k0, k1 = t0 * 64, min(tk, t1 * 64)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1],
                         k[:, :, k0:k1]) * scale
        qp = torch.arange(r0, r1)[:, None] + (tk - tq)
        kp = torch.arange(k0, k1)[None, :]
        valid = torch.ones(r1 - r0, k1 - k0, dtype=torch.bool)
        if causal:
            valid = qp > kp if fault == "diag" else qp >= kp
        valid = valid[None, None]
        if mask is not None:
            valid = valid & mask[:, None, None, k0:k1]
        s = torch.where(valid, s, torch.full_like(s, fa.NEG_INF))
        m = s.amax(-1, keepdim=True) if k1 > k0 else torch.full(
            (b, h, r1 - r0, 1), fa.NEG_INF)
        p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        parts.setdefault(qi, []).append(
            (t0, m, p.sum(-1, keepdim=True), p @ v[:, :, k0:k1]))
    for qi, chunks in parts.items():
        r0, r1 = qi * 64, min(tq, qi * 64 + 64)
        chunks.sort(key=lambda c: c[0])
        m = chunks[0][1]
        for c in chunks[1:]:
            m = torch.maximum(m, c[1])
        l = sum(c[2] * torch.exp(c[1] - m) for c in chunks)
        acc = sum(c[3] * torch.exp(c[1] - m) for c in chunks)
        out[:, :, r0:r1] = torch.where(l > 0, acc / torch.clamp(l, min=1e-30),
                                       torch.zeros_like(acc))
        row_lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
        if fault == "lse_row":
            row_lse = torch.cat([row_lse[..., 1:], row_lse[..., -1:]], -1)
        lse[:, :, r0:r1] = row_lse
    return out, lse


@pytest.mark.parametrize("bh_b,h,tq,tk,causal,masked", [
    (1, 12, 200, 200, True, False), (2, 3, 130, 300, True, True),
    (2, 2, 300, 100, True, False), (2, 3, 150, 150, False, True)])
def test_flash_items_algorithm_matches_jax(rng, flags_guard, bh_b, h, tq,
                                           tk, causal, masked):
    """K2's simt split-and-merge over the plan's items, in plain torch,
    against the JAX chunked attention (XLA) and its Pallas kernel in
    interpret mode at 1e-5, out and lse (rows that see no key: out
    exactly 0)."""
    from paddle_tpu.ops.pallas.flash_attention import (
        _flash_attention_fwd_tpu, chunked_attention)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    d = 32
    q = rng.randn(bh_b, h, tq, d).astype(np.float32)
    k = rng.randn(bh_b, h, tk, d).astype(np.float32)
    v = rng.randn(bh_b, h, tk, d).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((bh_b, tk), bool)
        mask[0, tk // 3:] = False
        mask[-1] = False
    chunk, items = fa.flash_plan(bh_b * h, tq, tk, causal,
                                 H100_FLASH_SLOTS[d])
    assert items is not None                 # the split path runs
    got, lse = _flash_items_plain(t(q), t(k), t(v), 0.125, causal,
                                  None if mask is None else t(mask), chunk,
                                  items)
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(chunked_attention(*map(jnp.asarray, (q, k, v)),
                                       scale=0.125, causal=causal,
                                       kv_mask=jm))
    np.testing.assert_allclose(n(got), ref, **TOL)
    out, ref_lse = _flash_attention_fwd_tpu(
        *map(jnp.asarray, (q, k, v)), 0.125, causal, 16, 32, kv_mask=jm,
        interpret=True, return_lse=True)
    np.testing.assert_allclose(n(got), np.asarray(out), **TOL)
    _, plse = fa.chunked_attention(t(q), t(k), t(v), 0.125, causal,
                                   None if mask is None else t(mask),
                                   return_lse=True)
    np.testing.assert_allclose(n(lse), n(plse), **TOL)
    if masked:
        assert float(n(got)[-1].__abs__().max()) == 0.0


@pytest.mark.parametrize("fault", ["none", "lse_row", "diag"])
def test_flash_fwd_card_check_fails_each_planted_fault(fault):
    """chip_smoke.py's K2 checks (``held_flash`` on out and its parts,
    lse within F32_TOL of its scale and absolutely) on the CPU at the
    serve path's first chunk cut to 2 heads, [1, 2, 512, 512, 64] causal,
    with the serve shape's split plan (chunk 2): the split-and-merge
    passes them, and each planted fault fails them."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 2, 512, 64, generator=g) for _ in range(3))
    chunk, items = fa.flash_plan(12, 512, 512, True, H100_FLASH_SLOTS[64])
    assert chunk == 2
    items = [(qi, t0, t1) for qi, t0, t1 in items]
    got, lse = _flash_items_plain(q, k, v, 0.125, True, None, chunk, items,
                                  None if fault == "none" else fault)
    want, wlse = fa.chunked_attention(q, k, v, 0.125, True, return_lse=True)
    _, q_parts, _ = chip_smoke.flash_parts(1, 2, 512, 512, True, None, "cpu")

    def checks():
        chip_smoke.held_flash("out", [("out", got, want, q_parts)],
                              chip_smoke.F32_TOL)
        held = chip_smoke.held("lse", [lse], [wlse], torch.float32)
        chip_smoke.check("lse", held["max_abs_err"], chip_smoke.F32_TOL)
    if fault == "none":
        checks()
        return
    with pytest.raises(AssertionError):
        checks()


def test_sdpa_matches_jax_causal_offset(rng):
    from paddle_tpu.ops.attention import scaled_dot_product_attention
    from paddle_tpu_torch.ops.attention import \
        scaled_dot_product_attention as port_sdpa
    q = rng.randn(2, 2, 5, 8).astype(np.float32)
    k = rng.randn(2, 2, 9, 8).astype(np.float32)
    v = rng.randn(2, 2, 9, 8).astype(np.float32)
    got = n(port_sdpa(t(q), t(k), t(v), causal=True))
    ref = np.asarray(scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(got, ref, **TOL)


# -------------------------------------------------- K7 paged decode attention

def _jax_pool(rng, lengths, dtype, kv_dtype, h=4, hd=16, ps=8, n_pages=24):
    from paddle_tpu.ops.attention import init_page_pool, paged_write
    s = len(lengths)
    pmax = max(-(-max(lengths) // ps), 1) + 1
    pool = init_page_pool(n_pages, h, ps, hd, dtype, kv_dtype=kv_dtype)
    ptab = np.zeros((s, pmax), np.int32)
    free = list(rng.permutation(n_pages))
    for i, ln in enumerate(lengths):
        pages = [int(free.pop()) for _ in range(-(-ln // ps))]
        ptab[i, :len(pages)] = pages
        if not ln:
            continue
        ids = np.asarray([ptab[i, p // ps] for p in range(ln)], np.int32)
        pool = paged_write(pool,
                           jnp.asarray(rng.randn(ln, h, hd), jnp.float32),
                           jnp.asarray(rng.randn(ln, h, hd), jnp.float32),
                           jnp.asarray(ids),
                           jnp.asarray(np.arange(ln) % ps, jnp.int32))
    return pool, ptab


@pytest.mark.parametrize("pool_kind", ["f32", "bf16", "int8"])
def test_paged_decode_matches_jax_xla_and_interpret(rng, flags_guard,
                                                    pool_kind):
    from paddle_tpu.ops.attention import _paged_attention_xla
    from paddle_tpu.ops.pallas.decode_attention import \
        paged_decode_attention_tpu
    from paddle_tpu_torch.ops.attention import paged_decode_attention
    lengths = [13, 0, 37, 8, 1, 16]          # ragged, partial pages, empty
    dtype = jnp.bfloat16 if pool_kind == "bf16" else jnp.float32
    kv = jnp.int8 if pool_kind == "int8" else None
    pool, ptab = _jax_pool(rng, lengths, dtype, kv)
    q = rng.randn(len(lengths), 4, 16).astype(np.float32)
    scale = 0.25
    args = (jnp.asarray(q), pool["k"], pool["v"], jnp.asarray(ptab),
            jnp.asarray(lengths, jnp.int32))
    ks, vs = pool.get("k_scale"), pool.get("v_scale")
    ref_xla = np.asarray(_paged_attention_xla(*args, scale, k_scale=ks,
                                              v_scale=vs))
    ref_int = np.asarray(paged_decode_attention_tpu(
        *args, scale, k_scale=ks, v_scale=vs, interpret=True, block_h=2))
    got = n(paged_decode_attention(
        t(q), t(pool["k"]), t(pool["v"]), t(ptab),
        torch.tensor(lengths, dtype=torch.int32), scale=scale,
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs)))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    np.testing.assert_allclose(got, ref_int, **TOL)
    assert float(np.abs(got[1]).max()) == 0.0      # length-0 slot: exact 0


# K7's split route: its plan, and its split-and-combine in plain torch

@pytest.mark.parametrize("slots,heads,pmax,sms", [
    (8, 12, 16, 132), (32, 12, 32, 132), (1, 1, 1, 132), (100, 12, 16, 132),
    (3, 4, 5, 132), (8, 12, 16, 1), (1, 12, 5000, 132), (2, 2, 7, 16)])
def test_decode_split_plan_covers_every_entry_once(slots, heads, pmax, sms):
    """Every page-table entry of a slot belongs to exactly one split, no
    split is empty at pmax, none stages more than SPLIT_MAX_PER entries,
    and the plan reads only shapes and the SM count."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    splits, per = da.split_plan(slots, heads, pmax, sms)
    owner = [j for j in range(splits)
             for _ in range(j * per, min((j + 1) * per, pmax))]
    assert owner == [e // per for e in range(pmax)]    # each entry once
    assert all(j * per < pmax for j in range(splits))  # none empty
    assert per <= da.SPLIT_MAX_PER
    blocks = slots * heads * splits
    assert blocks >= min(da.SPLIT_BLOCKS_PER_SM * sms,
                         slots * heads * -(-pmax // per))


@pytest.mark.parametrize("hd,route", [(64, "split"), (128, "split"),
                                      (256, "split"), (8, "split"),
                                      (40, "split"), (36, "simt"),
                                      (264, "simt"), (4, "simt")])
def test_decode_route_rule(hd, route):
    """K7's route: head dims that are multiples of 8 up to 256 take the
    split route, the rest the simt kernel."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    assert da.decode_route(hd) == route


@pytest.mark.parametrize("dtype,cols,route", [
    (torch.float32, 768, "row"), (torch.bfloat16, 768, "row"),
    (torch.float32, 1024, "row"), (torch.bfloat16, 1024, "row"),
    (torch.bfloat16, 2048, "row"), (torch.float32, 100, "row"),
    (torch.float32, 2048, "simt"), (torch.bfloat16, 770, "simt"),
    (torch.float32, 771, "simt"), (torch.bfloat16, 4096, "simt")])
def test_layer_norm_route_rule(dtype, cols, route):
    """K1's route: rows of whole 16-byte packs, at most 8 a lane, take
    the row route; the rest the simt kernel."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    assert ln.ln_route(dtype, cols) == route


LOG2E = 1.4426950408889634


def _split_decode_plain(q, k_pages, v_pages, page_table, lengths, scale,
                        splits, per, k_scale=None, v_scale=None,
                        fault=None):
    """The split route's algorithm in plain torch, for the tests only:
    split j of a slot owns its page-table entries [j per, (j + 1) per);
    each live split gives a partial (m in base 2, l, acc) over its tokens
    below the length; the live splits merge in split order. ``fault``
    plants one error as a copy of the kernel could have it: ``drop_last``
    (the last live token left out), ``past_length`` (one token past the
    length read), ``no_rescale`` (a split merged without its max rescale)
    and ``shift_pages`` (each split's page run one page late)."""
    s_slots, h, hd = q.shape
    ps = k_pages.shape[2]
    pmax = page_table.shape[1]
    pt = page_table.long()
    if fault == "shift_pages":
        pt = torch.cat([pt[:, 1:], pt[:, -1:]], 1)
    kg, vg = k_pages[pt].float(), v_pages[pt].float()
    if k_scale is not None:
        kg = kg * k_scale[pt][:, :, None, :, None]
        vg = vg * v_scale[pt][:, :, None, :, None]
    t = pmax * ps
    k = kg.movedim(2, 1).reshape(s_slots, h, t, hd)
    v = vg.movedim(2, 1).reshape(s_slots, h, t, hd)
    sc = torch.einsum("shd,shtd->sht", q.float(), k) * (scale * LOG2E)
    lens = lengths.long().clamp(0, t)
    if fault == "drop_last":
        lens = (lens - 1).clamp(min=0)
    if fault == "past_length":
        lens = (lens + 1).clamp(max=t)
    pos = torch.arange(t)
    parts = []
    for j in range(splits):
        lo = j * per * ps
        keep = (pos[None, :] >= lo) & (pos[None, :] < torch.minimum(
            lens[:, None], torch.tensor(lo + per * ps)))     # [S, T]
        keep = keep[:, None, :]
        m = torch.where(keep, sc, torch.full_like(sc, -1e30)).amax(-1)
        p = torch.where(keep, torch.exp2(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("sht,shtd->shd", p, v),
                      lo < lens[:, None].expand(s_slots, h)))
    gm = torch.full((s_slots, h), -1e30)
    for m, _, _, live in parts:
        gm = torch.where(live, torch.maximum(gm, m), gm)
    gl = torch.zeros(s_slots, h)
    acc = torch.zeros(s_slots, h, hd)
    for m, l, a, live in parts:
        w = (torch.ones_like(m) if fault == "no_rescale"
             else torch.exp2(m - gm))
        w = torch.where(live, w, 0.0)
        gl = gl + l * w
        acc = acc + a * w[..., None]
    return torch.where(gl[..., None] > 0, acc / gl.clamp(min=1e-30)[..., None],
                       0.0)


@pytest.mark.parametrize("pool_kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cut", ["one", "two", "many"])
def test_split_decode_plain_matches_jax(rng, flags_guard, pool_kind, cut):
    """The split route's split-and-combine, in plain torch, against the
    port's plain version and the JAX reference (XLA path and the Pallas
    kernel in interpret mode) at one split, two and one per page, with
    lengths on a split's boundary, one past it, 1 and 0."""
    from paddle_tpu.ops.attention import _paged_attention_xla
    from paddle_tpu.ops.pallas.decode_attention import \
        paged_decode_attention_tpu
    from paddle_tpu_torch.ops.cuda.decode_attention import \
        paged_attention_plain
    ps, pmax = 8, 6
    per = {"one": pmax, "two": 3, "many": 1}[cut]
    splits = -(-pmax // per)
    edge = per * ps if cut != "one" else 2 * ps     # a split's boundary
    lengths = [edge, edge + 1, 1, 0, (pmax - 1) * ps, edge - 1]
    dtype = jnp.bfloat16 if pool_kind == "bf16" else jnp.float32
    kv = jnp.int8 if pool_kind == "int8" else None
    pool, ptab = _jax_pool(rng, lengths, dtype, kv, n_pages=40)
    assert ptab.shape[1] == pmax
    q = rng.randn(len(lengths), 4, 16).astype(np.float32)
    scale = 0.25
    args = (jnp.asarray(q), pool["k"], pool["v"], jnp.asarray(ptab),
            jnp.asarray(lengths, jnp.int32))
    ks, vs = pool.get("k_scale"), pool.get("v_scale")
    ref_xla = np.asarray(_paged_attention_xla(*args, scale, k_scale=ks,
                                              v_scale=vs))
    ref_int = np.asarray(paged_decode_attention_tpu(
        *args, scale, k_scale=ks, v_scale=vs, interpret=True, block_h=2))
    targs = (t(q), t(pool["k"]), t(pool["v"]), t(ptab),
             torch.tensor(lengths, dtype=torch.int32), scale)
    tks = None if ks is None else t(ks)
    tvs = None if vs is None else t(vs)
    got = n(_split_decode_plain(*targs, splits, per, tks, tvs))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    np.testing.assert_allclose(got, ref_int, **TOL)
    np.testing.assert_allclose(got, n(paged_attention_plain(
        *targs, tks, tvs)), **TOL)
    assert float(np.abs(got[3]).max()) == 0.0      # length 0: exactly 0


@pytest.mark.parametrize("fault", ["none", "drop_last", "past_length",
                                   "no_rescale", "shift_pages"])
def test_decode_card_check_fails_each_planted_fault(fault):
    """chip_smoke.py's K7 check (``held_decode`` at F32_TOL) on the CPU,
    at the serve path's shape (8 slots x 12 heads, page size 64, hd 64,
    16 pages a slot, 16 splits of one page as the plan gives them on 132
    SMs) with chip_smoke.py's boundary lengths: the split-and-combine
    passes it, and each planted fault fails it."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator().manual_seed(3)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return torch.randn(*shape, generator=g).to(dtype) * scale

    lengths = [0, 1, 63, 64, 65, 700, 1024, 129]
    pool, ptab = chip_smoke.decode_pool("cpu", randn,
                                        np.random.RandomState(0), 8, 12, 64,
                                        64, 16, torch.bfloat16)
    q = randn(8, 12, 64)
    lens = torch.tensor(lengths, dtype=torch.int32)
    splits, per = da.split_plan(8, 12, 16, 132)
    assert (splits, per) == (16, 1)
    want = da.paged_attention_plain(q, pool["k"], pool["v"], ptab, lens,
                                    0.125)
    got = _split_decode_plain(q, pool["k"], pool["v"], ptab, lens, 0.125,
                              splits, per, fault=None if fault == "none"
                              else fault)
    if fault == "none":
        chip_smoke.held_decode("plain", got, want, lengths)
        return
    with pytest.raises(AssertionError):
        chip_smoke.held_decode(fault, got, want, lengths)


@pytest.mark.parametrize("pool_kind", ["f32", "int8"])
@pytest.mark.parametrize("ids", [[1, 4, 2, 4], [4, 4, 4, 4], [0, 3, 2, 1]])
def test_paged_write_drop_semantics_match_jax(rng, pool_kind, ids):
    """Page id == num_pages drops the row (mode="drop"); the port writes
    the pool in place and must leave it exactly as the reference does."""
    from paddle_tpu.ops.attention import init_page_pool, paged_write
    from paddle_tpu_torch.ops import attention as port
    kv = jnp.int8 if pool_kind == "int8" else None
    jpool = init_page_pool(4, 2, 8, 16, kv_dtype=kv)
    ppool = port.init_page_pool(4, 2, 8, 16, kv_dtype=(
        torch.int8 if kv else None), device="cpu")
    for step in range(2):                    # second write over the first
        k = rng.randn(4, 2, 16).astype(np.float32)
        v = rng.randn(4, 2, 16).astype(np.float32)
        offs = np.asarray([3, 0, 7, 5], np.int32) - step
        jpool = paged_write(jpool, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(ids, jnp.int32), jnp.asarray(offs))
        out = port.paged_write(ppool, t(k), t(v),
                               torch.tensor(ids, dtype=torch.int32),
                               torch.from_numpy(offs))
        assert out is ppool                     # in place
    for name in jpool:
        np.testing.assert_allclose(n(ppool[name]), np.asarray(jpool[name]),
                                   rtol=0, atol=1e-7)


def test_quantize_rows_matches_jax(rng):
    from paddle_tpu.ops.attention import quantize_kv_rows
    from paddle_tpu_torch.ops.attention import quantize_kv_rows as port_q
    x = rng.randn(9, 3, 16).astype(np.float32)
    x[4] = 0.0                                  # all-zero row: scale 0
    q, s = quantize_kv_rows(jnp.asarray(x))
    pq, ps = port_q(t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
    np.testing.assert_allclose(ps.numpy(), np.asarray(s), rtol=0, atol=0)


# --------------------------------------------- K2 / K3 route and card check

@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"),
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
])
def test_flash_route_rule(dtype, d, route):
    """K2's route: bf16 with a head dim of 64 or 128 (one or two [64, 64]
    TMA boxes per row) takes the tensor cores; bf16 at 16 or 32, and f32
    at every head dim, the SIMT kernel, so every case the SIMT kernel took
    before still runs."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    assert fa.flash_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"),
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "simt"),
])
def test_flash_bwd_route_rule(dtype, d, route):
    """K3's route: bf16 at D = 64 or 128 the tensor cores (as K2), f32 at
    D = 64 3xTF32 wgmma (its block does not fit at 128), every other case
    the SIMT kernels."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    assert fa.flash_bwd_route(dtype, d) == route


def test_flash_x3_plan_refuses_what_the_tf32x3_route_cannot_take(
        monkeypatch):
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    plan = fa.x3_plan(64)
    # csrc/flash_attention_bwd_x3.cu's kDqSmem and kDkvSmem
    assert (plan["dq_smem"], plan["dkv_smem"]) == (230424, 230936)
    for d in (16, 32, 128):
        with pytest.raises(ValueError, match="head dim"):
            fa.x3_plan(d)
    monkeypatch.setattr(core, "MAX_SMEM", plan["dkv_smem"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fa.x3_plan(64)
    # the op's setup raises too: no route gives way to another
    q = torch.zeros(1, 1, 8, 64)
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fa._bwd_setup(q, q, q, q, lse, lse, True, None, 0.125)


def test_flash_tf32x3_emulation_holds_f32_tol_and_1xtf32_does_not():
    """K3's seven products emulated bit for bit as the tf32x3 route
    rounds them (each operand split hi = tf32(x), lo = tf32(x - hi), three
    products, f32 sums; P and dS split as the kernels split their
    register fragments) at a causal [1, 2, 200, 200, 64] with a key mask
    (keys past 137 masked): dq, dk and dv within F32_TOL (1e-4,
    chip_smoke.py's f32 bar) of float64 on their own scale, and the keys
    no query sees exactly 0. One TF32 product a product (1xTF32) misses
    the bar: so the card's check at F32_TOL tells a dropped correction
    term."""
    f32_tol = 1e-4
    rs = np.random.RandomState(24)
    b, h, tq, tk, d = 1, 2, 200, 200, 64
    q, k, v, do = (torch.from_numpy(rs.randn(b, h, t_, d).astype(np.float32))
                   for t_ in (tq, tk, tk, tq))
    scale = d ** -0.5
    mask = torch.arange(tk)[None, :] < 137
    valid = (torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]) & mask

    def reference():
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        s = q64 @ k64.transpose(-1, -2) * scale
        s = torch.where(valid, s, torch.full_like(s, -torch.inf))
        lse = torch.logsumexp(s, -1)
        p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
        out = p @ v64
        delta = (do64 * out).sum(-1)
        dp = do64 @ v64.transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        return lse, delta, (ds @ k64 * scale,
                            ds.transpose(-1, -2) @ q64 * scale,
                            p.transpose(-1, -2) @ do64)

    lse, delta, want = reference()
    lse2 = (lse.float() * 1.4426950408889634).float()
    sc = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    rel = {}
    for terms in (3, 1):
        s = _tf32_mm(q, k.transpose(-1, -2).contiguous(), terms)
        dp = _tf32_mm(do, v.transpose(-1, -2).contiguous(), terms)
        p = torch.where(valid, torch.exp2(s * sc - lse2[..., None]), 0.0)
        ds = p * (dp - delta.float()[..., None])
        got = (_tf32_mm(ds, k, terms) * scale,
               _tf32_mm(ds.transpose(-1, -2).contiguous(), q, terms) * scale,
               _tf32_mm(p.transpose(-1, -2).contiguous(), do, terms))
        rel[terms] = {name: float((g.double() - w).abs().max()
                                  / w.abs().max())
                      for name, g, w in zip(("dq", "dk", "dv"), got, want)}
        if terms == 3:
            for g in got[1:]:
                assert float(g[..., 137:, :].abs().max()) == 0.0
    assert max(rel[3].values()) <= f32_tol, rel[3]
    assert min(rel[1].values()) > f32_tol, rel[1]


def _faulty_flash_bwd(q, k, v, out, lse, do, scale, causal, fault):
    """The plain backward's math (``flash_attention_bwd_plain``) with one
    of the faults planted in copies of the kernels to show that the card
    check can fail: dS without its scale, each row reading the next row's
    lse, the causal diagonal moved by one (``>`` for ``>=``), the last
    key dropped from the mask."""
    tq, tk = q.shape[2], k.shape[2]
    q_pos = torch.arange(tq)[:, None] + (tk - tq)
    k_pos = torch.arange(tk)[None, :]
    valid = torch.ones(tq, tk, dtype=torch.bool)
    if causal:
        valid = (q_pos > k_pos) if fault == "diag" else (q_pos >= k_pos)
    if fault == "dropkey":
        valid = valid & (k_pos < tk - 1)
    if fault == "lse_next":
        lse = torch.cat([lse[..., 1:], lse[..., -1:]], -1)
    delta = (do * out).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * (1.0 if fault == "noscale"
                                         else scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", p, do))


@pytest.mark.parametrize("fault", ["none", "noscale", "lse_next", "diag",
                                   "dropkey"])
def test_flash_card_check_fails_each_planted_fault(fault):
    """chip_smoke.py's K3 check (``held_flash`` at FLASH_BF16_TOL, the tc
    route's bar, and at F32_TOL, the f32 routes') on the CPU: the plain
    backward passes it, and each planted fault fails it at a causal
    [2, 3, 200, 200, 64] of f32 inputs. At the general bf16 bar (BF16_TOL) the
    dropped key moves the whole outputs by less than the bar (dq 2.3e-2,
    dk 1.5e-2, dv 8.7e-3 on the card); only the rows of the keys that few
    queries see show it, which is why the check holds them on their own
    scale."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator().manual_seed(3)
    b, h, tq, tk, d = 2, 3, 200, 200, 64
    q, k, v, do = (torch.randn(b, h, t_, d, generator=g)
                   for t_ in (tq, tk, tk, tq))
    scale = d ** -0.5
    out, lse = fa.chunked_attention(q, k, v, scale, True, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale, True)
    got = _faulty_flash_bwd(q, k, v, out, lse, do, scale, True, fault)
    _, q_parts, k_parts = chip_smoke.flash_parts(b, h, tq, tk, True, None,
                                                 "cpu")
    outs = [("dq", got[0], want[0], q_parts), ("dk", got[1], want[1],
                                                k_parts),
            ("dv", got[2], want[2], k_parts)]
    if fault == "none":
        chip_smoke.held_flash("plain", outs, chip_smoke.FLASH_BF16_TOL)
        # and at the f32 bar of the tf32x3 and SIMT routes
        chip_smoke.held_flash("plain", outs, chip_smoke.F32_TOL)
        return
    with pytest.raises(AssertionError):
        chip_smoke.held_flash(fault, outs, chip_smoke.FLASH_BF16_TOL)
    with pytest.raises(AssertionError):
        chip_smoke.held_flash(fault, outs, chip_smoke.F32_TOL)
    if fault == "dropkey":
        # at the general bf16 bar the whole outputs alone pass it; the
        # rows of the keys few queries see do not
        whole = [(name, a, w, {}) for name, a, w, _ in outs]
        chip_smoke.held_flash(fault, whole, chip_smoke.BF16_TOL)
        with pytest.raises(AssertionError):
            chip_smoke.held_flash(fault, outs, chip_smoke.BF16_TOL)


# ------------------------------------------------------------- device rule

def test_device_rule_cpu_plain_and_others_raise():
    from paddle_tpu_torch.ops.cuda import core
    cpu = torch.zeros(2)
    assert core.on_card(cpu, None, cpu) is False
    with pytest.raises(ValueError):
        core.on_card(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        core.on_card(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(TypeError):
        core.dtype_code(torch.zeros(2, dtype=torch.float64),
                        (torch.float32,))


def test_every_kernel_is_registered_with_its_sources():
    import os

    from paddle_tpu_torch.ops.cuda import core
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert set(core.KERNELS) == {
        "layer_norm", "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "mlp", "decode_attention", "xent_stats",
        "xent_bwd_dh", "xent_bwd_dwb", "add_layer_norm"}
    for kernel in core.KERNELS.values():
        assert os.path.isfile(os.path.join(root, kernel.source))
        for source in kernel.route_sources.values():
            assert os.path.isfile(os.path.join(root, source))
        path, line = kernel.replaces.split(":")
        with open(os.path.join(root, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert text.startswith("def _") and "kernel" in text
