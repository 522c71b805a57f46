"""The SIMT body's tile choice (``csrc/zo_matmul.cu``'s ``pick_tile``),
modelled on the CPU.

The launcher of ``zo_matmul``'s SIMT body (f32 X, or Gaussian z) picks
one of four output tiles from M, N, the lane count and the card's SMs:
the least modelled time, ceil(blocks / SMs) blocks an SM times a block's
outputs over the tile's share of issue slots left to FMAs (``kEff``),
ties to the larger tile, in integers. ``pick_tile`` below repeats that
arithmetic; the tests hold it to its definition (the least cost in exact
fractions), to the tiles the training paths' shapes take on a 132-SM
card, and to the grid limits. That the tile leaves every output's bits
as they are is held on the card (``tests/test_torch_gpu.py``); so is the
C function against the table here.
"""

from fractions import Fraction

import numpy as np
import pytest

from repro_torch.kernels.zo_perturb import SIMT_TILES

# csrc/zo_matmul.cu: kTileBM, kTileBN, kEff
EFF = (100, 84, 82, 60)
H100_SMS = 132


def _blocks(m, n, lanes, tile):
    bm, bn = tile
    return -(-m // bm) * -(-n // bn) * lanes


def pick_tile(m, n, lanes, sms):
    """``pick_tile``'s integer arithmetic: the index into SIMT_TILES."""
    best, best_work = 0, 0
    for i, (bm, bn) in enumerate(SIMT_TILES):
        work = -(-_blocks(m, n, lanes, (bm, bn)) // sms) * bm * bn
        if i == 0 or work * EFF[best] < best_work * EFF[i]:
            best, best_work = i, work
    return best


def _cost(m, n, lanes, sms, i):
    bm, bn = SIMT_TILES[i]
    waves = -(-_blocks(m, n, lanes, (bm, bn)) // sms)
    return Fraction(waves * bm * bn, EFF[i])


def test_tiles_split_evenly_over_256_threads():
    """Each tile is a 16 x 16 grid of threads, each a register tile of
    4 x 4 sub-tiles, and a 16-k stage splits into whole 4-element loads
    of X and W per thread."""
    assert len(SIMT_TILES) == len(EFF)
    for bm, bn in SIMT_TILES:
        assert bm % 64 == 0 and bn % 64 == 0
        assert (bm * 16 // 4) % 256 == 0 and (bn * 16 // 4) % 256 == 0


@pytest.mark.parametrize("seed", range(4))
def test_pick_tile_is_the_least_modelled_cost(seed):
    """The cross-multiplied comparison picks the first tile of least cost
    in exact fractions, over shapes from 1 to 60000, 1-64 lanes and
    card sizes from 1 to 160 SMs."""
    r = np.random.default_rng(seed)
    for _ in range(500):
        m = int(r.integers(1, 60000))
        n = int(r.integers(1, 60000))
        lanes = int(r.integers(1, 65))
        sms = int(r.integers(1, 161))
        costs = [_cost(m, n, lanes, sms, i) for i in range(len(EFF))]
        assert pick_tile(m, n, lanes, sms) == costs.index(min(costs))


# (M, N, lanes) -> tile on a 132-SM card: RoBERTa-large's projections at
# B 8 x 128 (q/k/v/o and w_out 1024 -> 1024 outputs, w_in 1024 -> 4096,
# the classifier's 8 CLS rows -> 2), the Gaussian arm at OPT-1.3B's
# w_in slice and LM head, and U0's 4 lanes of a (1024, 1024) product
PATH_TILES = {(1024, 1024, 1): (128, 64), (1024, 4096, 1): (256, 128),
              (8, 2, 1): (64, 64), (1024, 8192, 1): (256, 128),
              (1024, 50272, 1): (256, 128), (1024, 1024, 4): (256, 128)}


@pytest.mark.parametrize("shape", sorted(PATH_TILES), ids=str)
def test_pick_tile_at_the_paths_shapes(shape):
    m, n, lanes = shape
    assert SIMT_TILES[pick_tile(m, n, lanes, H100_SMS)] == PATH_TILES[shape]


def test_square_projection_fills_the_card():
    """RoBERTa's 1024 x 1024 outputs take the tile that runs one block on
    all but 4 of 132 SMs (128 blocks), not the 64 of 128 x 128."""
    i = pick_tile(1024, 1024, 1, H100_SMS)
    assert _blocks(1024, 1024, 1, SIMT_TILES[i]) == 128


@pytest.mark.parametrize("n", [1, 2, 50, 50272, 65535 * 64])
def test_grid_stays_in_cuda_limits(n):
    """grid.y (N tiles) stays <= 65535 for N up to 65535 * 64 (the
    launcher refuses more), grid.x covers M."""
    for m in (1, 37, 1024, 12000):
        bm, bn = SIMT_TILES[pick_tile(m, n, 1, H100_SMS)]
        assert -(-n // bn) <= 65535 and -(-m // bm) * bm >= m
