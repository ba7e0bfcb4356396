"""How the port's split weight gradients cut their work: dW [m, Cout] in
(bm, bn) tiles and each chunk's K steps in runs, one run a block, the
runs' f32 (or s32) tiles added in order afterwards. ``split_plan`` picks
the runs by a cost model of waves of blocks on an H100; the staged NV
wgrads (ops/cuda/bneck_nv_train.py ``wgrad_bf16_plan``,
``wgrad_int8_plan``, also the fused bf16 half's) and ``conv3x3_wgrad``
(ops/cuda/conv3x3.py ``wgrad_tma_plan``) plan with it. ``s8_model`` is
the TMA + s8 wgmma wgrad's model (csrc/wgrad_wgmma_s8.cuh), with which
the lane transition's (ops/cuda/transition.py ``wgrad_s8_plan``) and the
fused int8 half's (ops/cuda/fused_block.py ``fused_wgrad_s8_plan``) FQT
wgrads plan.
"""

from __future__ import annotations

from typing import NamedTuple

# the split picker's model of an H100 SXM (132 SMs, two blocks on each
# unless the caller says otherwise): a block's K step (128 bytes of each
# operand row: 64 bf16 or 128 int8 positions) takes STEP_US, its ring
# fill and epilogue FILL_STEPS more steps, and the split tiles (f32 or
# s32) go out and back in at PART_BYTES_US
SLOTS = 2 * 132
STEP_US = 2.0
FILL_STEPS = 2
PART_BYTES_US = 3.0e6


# csrc/wgrad_wgmma_s8.cuh: M rows a tile, positions (bytes) a K step, the
# bytes of a staged d row (the step and the 16-byte unit before it)
S8_BM, S8_BK, S8_XROW = 128, 128, 144
# its model of an H100 SXM, fitted to the kernel's times on the card
# (PERF.md): 132 SMs, one block on each; a block's time is the bytes
# its TMA boxes bring in (its staged d rows and its B rows) at up to 38 GB/s
# an SM and 4.4 TB/s in all (bytes a microsecond): the boxes of 144-byte
# rows, not the tensor cores, set the pace
S8_SMS = 132
S8_SM_BPUS = 3.8e4
S8_BPUS = 4.4e6


def s8_model(m: int, cout: int, n: int, bn: int, runs: int = 1,
             share: float = 1.0):
    """(blocks, waves, us) of the s8 wgrad's mainloop on dW [m, Cout] over
    ``n`` positions in (S8_BM, bn) tiles, ``runs`` blocks a tile, each
    bringing in ``share`` of its tile's bytes (every N tile's staged d
    rows, every M tile's B rows), at the smaller of an SM's rate and the
    card's rate shared by its wave's blocks."""
    m_tiles, n_tiles = -(-m // S8_BM), -(-cout // bn)
    blocks = m_tiles * n_tiles * runs
    waves = -(-blocks // S8_SMS)
    byts = n_tiles * m * n * S8_XROW / S8_BK + m_tiles * cout * n
    per = byts / (m_tiles * n_tiles) * share
    us = sum(per / min(S8_SM_BPUS, S8_BPUS / min(
        S8_SMS, blocks - w * S8_SMS)) for w in range(waves))
    return blocks, waves, us


class WgradPlan(NamedTuple):
    """How a split wgrad's mainloop cuts dW [taps*Cin, Cout] and each
    chunk's positions: (bm, bn) tiles, m_tiles x n_tiles of them; each of
    the ``chunks`` chunks has ``steps`` K steps of ``bk`` positions, cut
    into ``splits`` runs of ``per`` (``ranges``: each split's [kt0,
    kt1))."""
    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    chunks: int
    steps: int
    per: int
    splits: int
    ranges: tuple


def split_plan(m, cout, chunks, steps, bk, bn=None,
               slots=SLOTS) -> WgradPlan:
    """Tiles of dW [m, Cout] (``bn`` wide, else 64 where Cout <= 64 and
    128 above) and the splits of each chunk's ``steps`` K steps that
    minimize the cost model on ``slots`` blocks in flight, the fewest
    among equals, none empty."""
    bm = 64 if m <= 64 else 128
    if bn is None:
        bn = 64 if cout <= 64 else 128
    m_tiles, n_tiles = -(-m // bm), -(-cout // bn)
    tiles = m_tiles * n_tiles * chunks

    def cost(k):
        per = -(-steps // k)
        k = -(-steps // per)   # the splits runs of ``per`` steps make
        waves = -(-tiles * k // slots)
        # split tiles: 4 bytes an element, written once and read once
        return (waves * (per + FILL_STEPS) * STEP_US
                + 8 * chunks * k * m * cout / PART_BYTES_US)

    want = min(range(1, min(steps, 65535 // chunks) + 1), key=cost)
    per = -(-steps // want)
    splits = -(-steps // per)
    ranges = tuple((k * per, min(steps, (k + 1) * per))
                   for k in range(splits))
    return WgradPlan(bm, bn, bk, m_tiles, n_tiles, chunks, steps, per,
                     splits, ranges)
