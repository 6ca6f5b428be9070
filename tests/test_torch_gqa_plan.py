"""The launch plan of K3's GQA mode (``ops/gqa_decode_attention.py:gqa_plan``)
on the CPU: a plain function of the shapes, which the card's kernel checks
at launch.

    python -m pytest tests/test_torch_gqa_plan.py

Each valid case holds the plan's limits: blocks a head between 1 and 16,
never more than one a 64 live keys; a cluster taken at one block an SM only
where the card holds all of the launch's clusters at once; passes of 8 rows
that cover the KV head's ``rep * tq`` query rows; a grid the card takes; a
ring within its room and a block's shared memory within the H100's 227 KB.
On the H100's measured room a Qwen3-32B decode step at 4,096 keys takes 8
blocks a head. Each bad case raises. That every live key lands in exactly
one block is held on the card, where the kernel cuts the keys
(``tests/test_torch_kernels.py:test_gqa_kernel_matches_plain`` at the
plan's edges).
"""

from __future__ import annotations

import pytest

from whisper_mlx_tpu_torch.ops import gqa_decode_attention as gq

# the card's room for clusters of 16, 8 and 4 blocks at one block an SM
CARDS = {"h100": ({16: 7, 8: 15, 4: 30}, 132),  # an H100 80GB HBM3, measured
         "wide": ({16: 64, 8: 128, 4: 256}, 132), "none": (None, 132), "no SMs": (None, 0)}
# (b, n_kv, rep, tq, hd, bits, live, card, bad): Qwen3-32B's decode step at
# the plan's edges (1 key, one block a head to 2, 4 to 5, 16 and past, the
# longest cache), the other widths, slots, the verify's Tq 5, Tq 16 in 16
# passes, the grid's limits; then inputs the kernel does not take
PLAN_CASES = (
    [(1, 8, 8, 1, 128, 8, live, card, False)
     for live in (1, 64, 65, 256, 257, 1025, 4096, 4097, 32768) for card in ("h100", "wide")]
    + [(1, 8, 8, 1, 128, 4, live, "h100", False) for live in (1, 4096, 8191)]
    + [(1, 2, 7, 1, 64, 8, live, card, False) for live in (1, 2049, 32768)
       for card in ("h100", "none")]
    + [(4, 8, 8, 5, 128, 4, 4001, "h100", False), (4, 8, 8, 1, 128, 8, 4001, "h100", False),
       (1, 8, 8, 5, 128, 8, 4100, "h100", False), (1, 2, 8, 16, 128, 8, 3016, "h100", False),
       (1, 2, 7, 5, 128, 4, 2000, "h100", False), (3, 1, 4, 2, 64, 4, 32768, "h100", False),
       (2, 8, 5, 1, 128, 8, 1501, "h100", False), (65535, 1, 1, 1, 64, 4, 1, "h100", False),
       (1, 4095, 8, 16, 128, 8, 17, "h100", False)]
    + [(0, 8, 8, 1, 128, 8, 100, "h100", True), (65536, 8, 8, 1, 128, 8, 100, "h100", True),
       (1, 0, 8, 1, 128, 8, 100, "h100", True), (1, 8, 0, 1, 128, 8, 100, "h100", True),
       (1, 8, 8, 0, 128, 8, 100, "h100", True), (1, 8, 8, 17, 128, 8, 100, "h100", True),
       (1, 8, 8, 1, 96, 8, 100, "h100", True), (1, 8, 8, 1, 128, 2, 100, "h100", True),
       (1, 8, 8, 1, 128, 8, 0, "h100", True), (1, 8, 8, 1, 128, 8, 32769, "h100", True),
       (1, 8, 8, 1, 128, 8, 100, "no SMs", True), (1, 4096, 8, 16, 128, 8, 100, "h100", True)]
)


@pytest.mark.parametrize("b,n_kv,rep,tq,hd,bits,live,card,bad", PLAN_CASES)
def test_gqa_plan(b, n_kv, rep, tq, hd, bits, live, card, bad):
    room, sms = CARDS[card]
    kw = dict(room=room, sms=sms)
    if bad:
        with pytest.raises(ValueError, match="gqa_plan"):
            gq.gqa_plan(b, n_kv, rep, tq, hd, bits, live, **kw)
        return
    plan = gq.gqa_plan(b, n_kv, rep, tq, hd, bits, live, **kw)
    # blocks a head within their limits; a held launch fits on the card at once
    assert 1 <= plan.blocks <= min(gq.MAX_BLOCKS, -(-live // gq.SPLIT)) <= 16
    assert plan.cluster == (plan.blocks, 1, 1)
    if plan.held:
        assert b * plan.grid[1] <= room[plan.blocks]
    # rows a pass cover the KV head's rep x tq rows, padded to one n8 tile
    assert plan.rows == 8
    assert (plan.passes - 1) * plan.rows < rep * tq <= plan.passes * plan.rows
    assert plan.grid == (plan.blocks, n_kv * plan.passes, b) and plan.grid[1] <= 65535
    # the ring and the block's shared memory within their room
    assert 1 <= plan.stages <= gq.gqa_ring_slots(hd, bits, plan.held) <= gq.MAX_STAGES
    assert plan.smem == gq.gqa_smem(hd, bits, plan.stages) <= 227 * 1024
    # a Qwen3-32B decode step at 4,096 keys: 8 clusters of 8 blocks on the
    # H100 (it holds 7 clusters of 16 at one block an SM), each block's 512
    # keys in flight at once; 16 blocks of 256 keys on a card holding them
    if (b, n_kv, rep, tq, hd, bits, live) == (1, 8, 8, 1, 128, 8, 4096):
        assert (plan.blocks, plan.stages, plan.held) == ((8, 4, True) if card == "h100" else
                                                        (16, 2, True))
