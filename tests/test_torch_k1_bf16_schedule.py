"""K1-bf16's schedule (``sparse/conv.py:k1_bf16_schedule``): the tile and
the split of the reduction that ``csrc/subm_conv_bf16.cu`` runs, checked on
the CPU at the full-width ISBNet's 14 forward conv shapes and the tiny
configuration's, in both of the kernel's functions (``round_taps``: each
tap's sum rounded to bf16, which takes a fourth accumulator), on a card of
132 SMs (H100 SXM), 114 (H100 PCIe) and one. What the kernel relies on:

* every split of the reduction holds whole taps (with ``round_taps`` a tap's
  sum is rounded once, when its channels end), and every chunk falls in
  exactly one split, none empty; at most 8 splits, a cluster's blocks;
* the warpgroup's width is a legal ``wgmma`` N (a multiple of 8 up to 256)
  and an instantiated tile (``K1_BF16_TILES``, the kernel's ``launcher``);
* the registers a thread needs stay within 255 by the estimate, a block's
  shared memory within the 227 KB an H100 gives it, and a tile covers the
  whole Cout where that allows it (one gather of a row a block).
"""

import re
from pathlib import Path

import pytest

import chip_smoke as cs
from gapro_tpu_torch.models import isbnet
from gapro_tpu_torch.sparse import conv
from gapro_tpu_torch.sparse.plan import level_capacities

_FULL = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
_TINY = isbnet.ISBNetConfig(channels=8, num_blocks=3)
SHAPES = sorted(
    set(cs.k1_shape_counts(_FULL, level_capacities(cs.N_CAP, _FULL.num_blocks, cs.FULL_SHRINK)))
    | set(cs.k1_shape_counts(_TINY, level_capacities(2048, _TINY.num_blocks, 0.7))))
SMS = (132, 114, 1)
CHUNK = conv.K1_BF16_CHUNK


def _schedules(v, cin, cout, round_taps):
    k = -(-cin // 8) * 8  # the wrapper pads the stem's 6 channels to 8
    return k, [conv.k1_bf16_schedule(v, k, cout, sms, round_taps) for sms in SMS]


def test_the_full_width_shapes_are_fourteen():
    full = cs.k1_shape_counts(_FULL, level_capacities(cs.N_CAP, _FULL.num_blocks,
                                                      cs.FULL_SHRINK))
    assert len(full) == 14 and sum(full.values()) == 53


@pytest.mark.parametrize("round_taps", [False, True])
@pytest.mark.parametrize("v,cin,cout", SHAPES)
def test_splits_hold_whole_taps_and_every_chunk_once(v, cin, cout, round_taps):
    k, scheds = _schedules(v, cin, cout, round_taps)
    for s in scheds:
        assert s.n_chunks == -(-27 * k // CHUNK)
        assert 1 <= s.splits <= conv.K1_BF16_MAX_SPLITS
        seen = []
        for z in range(s.splits):
            chunks = s.split_chunks(z)
            assert len(chunks) > 0, f"split {z} of {s} is empty"
            lo, hi = chunks.start * CHUNK, min(chunks.stop * CHUNK, 27 * k)
            assert lo % k == 0 and hi % k == 0, f"split {z} of {s} cuts a tap"
            seen.extend(chunks)
        assert seen == list(range(s.n_chunks))


@pytest.mark.parametrize("round_taps", [False, True])
@pytest.mark.parametrize("v,cin,cout", SHAPES)
def test_the_tile_is_legal_and_fits(v, cin, cout, round_taps):
    _, scheds = _schedules(v, cin, cout, round_taps)
    for s in scheds:
        assert s.bn % 8 == 0 and 8 <= s.bn <= 256
        assert (s.wgn, s.bn, round_taps, s.paired) in conv.K1_BF16_TILES
        assert s.regs <= 255
        assert s.shared_bytes <= 232448  # a block's most
        assert s.blocks * (s.shared_bytes + 1024) <= conv.K1_BF16_SHARED
        assert s.stages == 1 if not s.paired else 1 <= s.stages <= conv.K1_BF16_MAX_STAGES
        # the whole Cout (a row gathered once a block), but past 192 columns
        # with round_taps, where 255 registers hold at most 2 x 96
        assert -(-cout // s.cols) == 1 or (round_taps and cout > 192)


def test_the_tiles_are_the_kernels():
    """``K1_BF16_TILES`` lists what the kernel's launcher instantiates, and
    every tile the schedule picks is one of them."""
    src = (Path(conv.__file__).resolve().parents[1] / "csrc" / "subm_conv_bf16.cu").read_text()
    body = src[src.index("Launcher launcher("):src.index("}  // namespace")]
    tiles = set()
    for line in body.splitlines():
        wgn = re.search(r"wgn == (\d)", line)
        for bn, w, r, p in re.findall(r"launch<(\d+), (\d), (true|false), (true|false)>", line):
            tiles.add((int(w), int(bn), r == "true", p == "true"))
        assert wgn is None or int(wgn.group(1)) in (1, 2)
    assert tiles == conv.K1_BF16_TILES


def test_the_schedule_at_full_width():
    """The tiles and splits the 14 full-width shapes take on 132 SMs, as
    PERF.md gives them: levels 0-1 as the design before (unpaired), levels
    2-6 paired on the whole Cout; levels 0-3 split as the design before (so
    its output is bit-equal there), levels 4-6 over a cluster of 7."""
    full = cs.k1_shape_counts(_FULL, level_capacities(cs.N_CAP, _FULL.num_blocks,
                                                      cs.FULL_SHRINK))
    got = {}
    for v, cin, cout in full:
        s = conv.k1_bf16_schedule(v, -(-cin // 8) * 8, cout, 132, cout <= 128)
        got[(v, cin, cout)] = (s.rows, s.cols, s.paired, s.splits)
    assert got == {
        (262144, 6, 32): (128, 32, False, 1), (262144, 32, 32): (128, 32, False, 1),
        (262144, 64, 32): (128, 32, False, 1), (176128, 64, 64): (128, 64, False, 1),
        (176128, 128, 64): (128, 64, False, 1), (52992, 96, 96): (64, 96, True, 1),
        (52992, 192, 96): (64, 96, True, 1), (13312, 128, 128): (64, 128, True, 2),
        (13312, 256, 128): (64, 128, True, 2), (3328, 160, 160): (64, 160, True, 7),
        (3328, 320, 160): (64, 160, True, 7), (1024, 192, 192): (64, 192, True, 7),
        (1024, 384, 192): (64, 192, True, 7), (256, 224, 224): (64, 224, True, 7)}
