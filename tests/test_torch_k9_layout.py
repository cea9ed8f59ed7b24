"""K9's plan and walk (``ops/kernels/vmem_gather.py``,
``csrc/vmem_gather.cu``) on the CPU.

``window_plan`` picks the widest lanes of a work item whose window fits the
shared memory once (16 at W = 2048, 8 at 4096, 4 at 8192) and a ring of
TMA box slots of one window and more up to two within 192 KB (12, 24 and
48 slots for windows of 8, 16 and 32 boxes), the box arithmetic (boxes
of at most 256 rows covering W, 16-byte inner rows, 128-byte slots) and
one persistent CTA per SM;
``cta_items`` gives every item to one CTA.  The kernel's walk is emulated
in numpy as the kernel runs it: boxes issued in order into slot seq %
slots (item 0's alone, item k + 1's first boxes once item k's window has
landed, the rest once item k is done), each box only onto a slot whose
item is done, batches of 8 passes of 1024 / cols rows with the next
batch's idx loaded before the current one is gathered, row j of item k
read at ring row (base + j) mod ring rows.  It is held to
``window_gather_plain`` bit for bit, float32, at R = 1, 3 and 8, W not a
multiple of the box or of a pass, idx at 0 and W - 1, fewer CTAs than
items and one block.
"""

import numpy as np
import pytest
import torch

from lammps_user_conp2_tpu_torch.exp_vmem_gather import PROBE_SHAPES
from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather as k9

U = 8       # csrc/vmem_gather.cu WG_U


@pytest.mark.parametrize("nb,W,cols,slots", [(32, 2048, 16, 12),
                                             (32, 4096, 8, 24),
                                             (8, 8192, 4, 48)])
def test_plan_at_the_probe_shapes(nb, W, cols, slots):
    assert (nb, W) in PROBE_SHAPES
    p = k9.window_plan(nb, W, 132)
    assert (p.cols, p.slots, p.box_rows) == (cols, slots, 256)
    assert p.nbox * p.box_bytes == W * cols * 4          # one window
    assert p.smem == k9.BAR_BYTES + slots * p.box_bytes <= k9.SMEM_LIMIT
    assert p.items == nb * 128 // cols and p.grid == 132


@pytest.mark.parametrize("W", [1, 13, 40, 255, 256, 257, 1000, 2047, 2049,
                               5000, 14336])
def test_box_arithmetic(W):
    p = k9.window_plan(3, W, 132)
    assert 1 <= p.box_rows <= k9.BOX_ROWS
    assert (p.nbox - 1) * p.box_rows < W <= p.nbox * p.box_rows
    assert p.cols * 4 % 16 == 0                      # the TMA inner box
    assert p.box_bytes == p.box_rows * p.cols * 4
    assert p.box_bytes % 128 == 0                    # slot destinations
    assert p.nbox <= p.slots <= 2 * p.nbox
    assert p.smem <= k9.SMEM_LIMIT
    # a wider item's window would not have fitted; nor a slot more
    for c in (16, 8, 4):
        if c > p.cols:
            assert k9.BAR_BYTES + W * c * 4 > k9.SMEM_LIMIT
    if p.slots < 2 * p.nbox:
        assert p.slots == p.nbox or (
            (p.slots + 1) * p.box_bytes > k9.RING_BUDGET)


@pytest.mark.parametrize("nb,W,sms", [(32, 2048, 132), (32, 4096, 132),
                                      (8, 8192, 132), (1, 40, 132),
                                      (3, 300, 7)])
def test_every_item_on_one_cta(nb, W, sms):
    p = k9.window_plan(nb, W, sms)
    assert p.grid == min(p.items, sms)
    walks = [list(k9.cta_items(p, b)) for b in range(p.grid)]
    flat = sorted(i for w in walks for i in w)
    assert flat == list(range(p.items))
    sizes = [len(w) for w in walks]
    assert max(sizes) - min(sizes) <= 1
    # round k holds the items [k grid, (k + 1) grid): neighbouring lane
    # groups of the same blocks side by side
    for k in range(max(sizes)):
        rnd = sorted(w[k] for w in walks if len(w) > k)
        assert rnd == list(range(k * p.grid, k * p.grid + len(rnd)))


def _emulate(win, idx, R, p, slots=None):
    """The kernel's walk in numpy, float32, CTA by CTA (``slots`` overrides
    the plan's ring)."""
    nb, W, lanes = win.shape
    C, nbox, br = p.cols, p.nbox, p.box_rows
    S = p.slots if slots is None else slots
    G = lanes // C
    P = k9.THREADS // C
    batches = -(-(-(-W // P)) // U)
    out = np.full(win.shape, np.nan, np.float32)
    tid = np.arange(k9.THREADS)
    c, r0 = tid % C, tid // C
    for b in range(p.grid):
        mine = len(k9.cta_items(p, b))
        ring = np.full((S * br, C), np.nan, np.float32)
        owner = [None] * S                           # (item k, box q)
        done = set()
        state = dict(next_box=0)

        def issue_upto(limit):
            limit = min(limit, mine * nbox)
            while state["next_box"] < limit:
                seq = state["next_box"]
                k, q = divmod(seq, nbox)
                slot = seq % S
                if owner[slot] is not None:          # a slot still in use
                    assert owner[slot][0] in done
                t, g = divmod(b + k * p.grid, G)
                box = np.zeros((br, C), np.float32)  # past W: zero-filled
                rows = win[t, q * br:(q + 1) * br, g * C:(g + 1) * C]
                box[:rows.shape[0]] = rows
                ring[slot * br:(slot + 1) * br] = box
                owner[slot] = (k, q)
                state["next_box"] += 1

        def load(it):
            k, bi = divmod(it, batches)
            t, g = divmod(b + k * p.grid, G)
            return [np.where((bi * U + u) * P + r0 < W,
                             idx[t, np.minimum((bi * U + u) * P + r0, W - 1),
                                 g * C + c], 0) for u in range(U)]

        issue_upto(nbox)
        total = mine * batches
        nxt = load(0)
        for it in range(total):
            cur = nxt
            if it + 1 < total:
                nxt = load(it + 1)
            k, bi = divmod(it, batches)
            if bi == 0:
                # the barrier: every box of item k has landed
                assert state["next_box"] >= (k + 1) * nbox
                assert all(owner[(k * nbox + q) % S] == (k, q)
                           for q in range(nbox))
                issue_upto(min(k * nbox + S, (k + 2) * nbox))
            t, g = divmod(b + k * p.grid, G)
            base = (k * nbox % S) * br
            for u in range(U):
                w = (bi * U + u) * P + r0
                ok = w < W
                j = np.mod(cur[u], W)
                rr = (base + j) % (S * br)
                acc = np.zeros(k9.THREADS, np.float32)
                for _ in range(R):
                    acc = acc + ring[rr, c]
                    j = j + 1
                    wrap = j == W
                    rr = np.where(wrap, base, (rr + 1) % (S * br))
                    j = np.where(wrap, 0, j)
                out[t, w[ok], g * C + c[ok]] = acc[ok]
            if bi == batches - 1 and k + 1 < mine:
                done.add(k)
                issue_upto(min((k + 1) * nbox + S, (k + 2) * nbox))
    return out


@pytest.mark.parametrize("nb,W,R,sms", [(2, 40, 8, 132), (3, 300, 3, 5),
                                        (2, 1000, 1, 3), (1, 2049, 8, 4),
                                        (2, 4100, 3, 7)])
def test_emulated_walk_matches_plain(nb, W, R, sms):
    rng = np.random.default_rng(W + R)
    win = rng.standard_normal((nb, W, 128)).astype(np.float32)
    idx = rng.integers(0, W, size=(nb, W, 128)).astype(np.int32)
    idx[0, :3] = 0
    idx[-1, -3:] = W - 1
    p = k9.window_plan(nb, W, sms)
    assert p.grid < p.items or W == 40
    ref = k9.window_gather_plain(torch.from_numpy(win), torch.from_numpy(idx),
                                 R).numpy()
    # the plan's ring, and the fullest and emptiest rings the kernel takes
    for slots in (None, p.nbox, 2 * p.nbox, p.nbox + 1):
        got = _emulate(win, idx, R, p, slots)
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got, ref)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    win = torch.zeros((1, 8, 128))
    idx = torch.zeros((1, 8, 128), dtype=torch.int32)
    before = k9.launches.count
    assert torch.equal(k9.window_gather(win, idx, 2), torch.zeros_like(win))
    assert k9.launches.count == before
