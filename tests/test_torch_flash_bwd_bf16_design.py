"""The design of the bf16 flash backward's Hopper kernel
(``flash_bwd_bf16_hopper``, csrc/flash_attention_bwd.cu), checked on the
CPU where the kernel cannot run.

One launch forms the 5 products of every live (query, key) pair: a CTA
owns a block of keys of one KV head and streams the query tiles of its G
heads, so dK and dV are summed in registers, and each query tile's dQ is
summed across the key blocks that reach it in a fixed order: an f32
workspace behind a counter a (b, h, query tile), the last key block
first, the last adder adding the sum to its own partial, scaling and
rounding to bf16 once. Two parts:

* the arithmetic, emulated in plain PyTorch: the bf16 backward kernel's
  rounding points (``kernel_bwd_emulated`` of tests/
  test_torch_train_bf16.py) with dQ as that ordered sum of per-key-block
  f32 partials, against the plain bf16 backward over 8 seeds of each of
  that file's attention cases, within 2 x the plain version's own
  bf16-vs-f32 RMS distance (the card's rule for the kernel). The cases'
  sequences are short, so the emulation takes tiles of 16 (and 8 queries
  by 32 keys) to sum over several key blocks; the kernel's tiles only
  partition the same sums;
* the work list and add order (``kernel.bf16_bwd_design``, the Python
  mirror of the kernel's ticket order, ``tile_kblocks`` and
  ``kblock_tiles``) at phase 16's eight shapes of ``chip_smoke.py`` and
  the card tests' shapes: every live (key block, query tile, head) pair,
  live by the mask element by element, is visited once; each tile's adds
  have ranks 0 .. count − 1 from its last key block down, with every
  predecessor's item earlier in the ticket order (so CTAs that start in
  any order never wait on one that has not started); the tiles with no
  live key are exactly those listed for D's launch to zero.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import _masked_scores
from repro_torch.kernels.flash_attention.kernel import (BF16_BWD_TILES,
                                                        bf16_bwd_design,
                                                        tile_kblocks)
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_train_bf16 import (ATTN_CASES, BF16, F32, RATIO, as_f32,
                                   attention_inputs, bf16_pair,
                                   kernel_bwd_emulated, rms_share)


def ordered_dq(q, k, v, out, dout, lse, *, causal, window, softcap, BM, BN):
    """dQ as ``flash_bwd_bf16_hopper`` sums it: dS as the kernel forms it
    (as ``kernel_bwd_emulated`` does, rounded to bf16), one f32 partial bf16(dS)
    K a (key block, query tile), the partials of a tile summed from its
    last live key block down, the last one added to the sum, the total
    times 1/√hd, rounded to bf16 once."""
    Bq, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G, scale, off = H // K, 1.0 / math.sqrt(hd), T - Sq
    qg = q.to(F32).reshape(Bq, Sq, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(F32)) * scale
    cap = torch.ones_like(s)
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s, cap = th * softcap, 1 - th * th
    live = torch.isfinite(_masked_scores(q, k, causal, window, softcap))
    p = torch.where(live, torch.exp(s - lse.reshape(Bq, K, G, Sq, 1)),
                    torch.zeros(()))
    do = dout.to(F32).reshape(Bq, Sq, K, G, hd)
    d = (dout.to(F32) * out.to(F32)).sum(-1).reshape(Bq, Sq, K, G)
    dp = torch.einsum("bskgh,btkh->bkgst", do, v.to(F32))
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None]) * cap
    dsr = ds.to(BF16).to(F32)
    kf = k.to(F32)
    nkb, nqt = -(-T // BN), -(-Sq // BM)
    dq = torch.zeros((Bq, K, G, Sq, hd), dtype=F32)
    for m in range(nqt):
        rows = slice(m * BM, min(Sq, m * BM + BM))
        klo, khi = tile_kblocks(m, BM, BN, nkb, off, causal, window or 0)
        acc = None
        for n in range(khi - 1, klo - 1, -1):
            keys = slice(n * BN, min(T, n * BN + BN))
            part = torch.einsum("bkgst,btkh->bkgsh", dsr[..., rows, keys],
                                kf[:, keys])
            acc = part if acc is None else acc + part
        if acc is not None:
            dq[..., rows, :] = acc * scale
    return dq.permute(0, 3, 1, 2, 4).reshape(q.shape).to(BF16)


@pytest.mark.parametrize("BM,BN", [(16, 16), (8, 32)])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_ordered_dq_sum_within_twice_the_plain_error(case, BM, BN):
    """The kernel's dQ, its per-key-block partials summed in its fixed
    order, against the plain bf16 backward over 8 seeds: within 2 x the
    plain version's own distance from the plain f32 backward; dK and dV
    as the emulation forms them."""
    _, _, _, _, _, _, causal, window, softcap, _ = ATTN_CASES[case]
    kw = dict(causal=causal, window=window, softcap=softcap)
    for seed in range(8):
        q, k, v, dout = (bf16_pair(a)[1]
                         for a in attention_inputs(case, 10 + seed))
        out = flash_attention_ref(q, k, v, **kw)
        lse = flash_attention_lse_ref(q, k, **kw)
        dq = ordered_dq(q, k, v, out, dout, lse, BM=BM, BN=BN, **kw)
        _, dk, dv = kernel_bwd_emulated(q, k, v, out, dout, lse, **kw)
        plain16 = flash_attention_bwd_ref(q, k, v, dout, **kw)
        plain32 = flash_attention_bwd_ref(*(t.to(F32) for t in (q, k, v,
                                                                dout)), **kw)
        for name, g, p16, p32 in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                     plain16, plain32):
            assert g.dtype == BF16 and bool(torch.isfinite(g).all())
            mine = rms_share(as_f32(g), as_f32(p16), as_f32(p32))
            own = rms_share(as_f32(p16), as_f32(p32), as_f32(p32))
            assert 0 < own and mine <= RATIO * own, (name, seed, mine, own)


# (B, S, T, H, K, hd, causal, window): chip_smoke.py phase 16's eight cases
# (granite-8b train and serve, gemma-7b at hd 256 with and without a cap,
# gemma3-27b's local layers, seamless's cross-attention, ragged S below
# and above T), then the card tests' shapes of the bf16 backward
DESIGN_SHAPES = [
    (8, 256, 256, 32, 8, 128, True, None),
    (4, 2048, 2048, 32, 8, 128, True, None),
    (4, 1024, 1024, 16, 16, 256, True, None),
    (4, 2048, 2048, 32, 16, 128, True, 1024),
    (4, 700, 2048, 16, 16, 64, False, None),
    (2, 1000, 1537, 16, 8, 128, True, None),
    (2, 1537, 1000, 16, 8, 128, True, None),
    (1, 130, 130, 16, 16, 128, True, None),
    (1, 130, 130, 48, 8, 128, True, None),
    (2, 77, 93, 4, 2, 64, True, None),
    (1, 171, 250, 4, 2, 256, True, None),
    (1, 150, 300, 8, 4, 128, True, 70),
    (1, 300, 150, 8, 4, 64, True, 40),
    (1, 200, 200, 4, 4, 256, True, 64),
    (1, 100, 60, 4, 2, 256, True, None),
    (2, 90, 200, 4, 4, 256, False, None),
    (1, 150, 190, 4, 2, 64, True, 100),
    (8, 256, 256, 48, 8, 128, True, 4096),
]


def live_blocks(S, T, BM, BN, causal, window):
    """live[m, n]: some query of tile m sees some key of block n, by the
    mask element by element (query i at key position i + T − S)."""
    i = np.arange(S)[:, None] + (T - S)
    j = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= j > i - window
    nqt, nkb = -(-S // BM), -(-T // BN)
    pad = np.zeros((nqt * BM, nkb * BN), bool)
    pad[:S, :T] = ok
    return pad.reshape(nqt, BM, nkb, BN).any(axis=(1, 3))


@pytest.mark.parametrize("shape", DESIGN_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:6])) + (
                             "-causal" if s[6] else "") + (
                             f"-w{s[7]}" if s[7] else ""))
def test_work_list_visits_every_live_pair_once_in_order(shape):
    B, S, T, H, K, hd, causal, window = shape
    d = bf16_bwd_design(B, S, T, H, K, hd, causal, window)
    BM, BN = BF16_BWD_TILES[hd]
    assert d["tiles"] == (BM, BN)
    live = live_blocks(S, T, BM, BN, causal, window)
    nqt, nkb = live.shape
    assert d["ctas"] == nkb * B * K == len(set(d["items"]))
    G = H // K
    seen = {}
    for pos, ((n, b, kh), its) in enumerate(zip(d["items"], d["iterations"])):
        # a CTA visits its tiles in order, each with its G heads
        assert [m for m, _, _, _ in its] == sorted(m for m, _, _, _ in its)
        for m, h, rank, count in its:
            assert h // G == kh and live[m, n]
            key = (b, h, m)
            assert (key, n) not in seen, "a pair visited twice"
            seen[(key, n)] = (pos, rank, count)
    # every live pair of every (b, h) once
    want = {((b, h, m), n) for b in range(B) for h in range(H)
            for m, n in zip(*np.nonzero(live))}
    assert set(seen) == want
    # each tile's adds: ranks 0 .. count − 1 from the last key block down,
    # each predecessor's item earlier in the ticket order
    by_tile = {}
    for (key, n), (pos, rank, count) in seen.items():
        by_tile.setdefault(key, []).append((n, pos, rank, count))
    for key, adds in by_tile.items():
        adds.sort(reverse=True)                   # last key block first
        assert [a[2] for a in adds] == list(range(len(adds)))
        assert all(a[3] == len(adds) for a in adds)
        assert all(x[1] < y[1] for x, y in zip(adds, adds[1:]))
    # the tiles no key block reaches: listed for zeroing, and only those
    dead = {(b, h, m) for b in range(B) for h in range(H) for m in range(nqt)
            if not live[m].any()}
    assert set(d["dead_tiles"]) == dead
    assert dead.isdisjoint(by_tile)
    assert d["bytes"] > d["workspace_bytes"] >= 0
