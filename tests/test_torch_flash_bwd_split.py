"""The error budget of the flash backward's Hopper kernel (``flash_bwd_hopper``
in src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu),
emulated on the CPU in plain PyTorch.

At head widths 64, 128 and 256 the kernel forms every product on bf16
``wgmma``: each f32 operand (Q, K, V, dO, and P and dS from registers) is
taken as bf16 pieces, x1 = bf16(x), x2 = bf16(x − x1), and a product of two
split operands is the passes i + j < k over the pieces (k = 2: x2·y1, x1·y2,
then x1·y1), each exact in bf16 × bf16 and summed in f32. The emulation
below forms the five products of the backward so (S = QKᵀ, dP = dO Vᵀ,
dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K) from the f32 forward's LSE and D = rowsum
(dO ∘ O), and holds each gradient against a float64 backward at the widths
and masks of chip_smoke.py's phase 16, cut in length: with two pieces every
gradient stays within 2e-4 of its scale (the card's ``BWD_RTOL``), with one
piece (each operand rounded to bf16 once) at least one lands above it, so
the check on the card tells one piece from two.
"""

import math

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

BWD_RTOL = 2e-4      # chip_smoke.py's phase 16 and tests/test_torch_lm_cuda.py

# phase 16's cases cut in length: (label, (B, S, T, H, K, hd), causal,
# window, softcap)
CASES = [
    ("granite", (1, 160, 160, 4, 1, 128), True, None, None),
    ("gemma-7b-hd256", (1, 130, 130, 2, 2, 256), True, None, None),
    ("gemma-7b-hd256-cap", (1, 130, 130, 2, 2, 256), True, None, 50.0),
    ("gemma3-local", (1, 200, 200, 2, 1, 128), True, 64, None),
    ("seamless-cross", (1, 70, 150, 2, 2, 64), False, None, None),
    ("ragged-offset", (1, 100, 153, 2, 1, 128), True, None, None),
    ("ragged-dead-rows", (1, 153, 100, 2, 1, 128), True, None, None),
]


def bf16_pieces(x, k):
    """x (f32) as k bf16 values (held in f32), each rounding (RNE, as
    cvt.rn.bf16x2.f32) what the ones before it leave."""
    out = []
    for _ in range(k):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def split_product(a, b, k):
    """a @ b as the kernel forms it from k bf16 pieces of each operand: the
    passes i + j < k, smallest first, each exact and rounded to f32, summed
    in f32 in that order."""
    pa, pb = bf16_pieces(a.float(), k), bf16_pieces(b.float(), k)
    passes = sorted(((i, j) for i in range(k) for j in range(k) if i + j < k),
                    key=lambda ij: -(ij[0] + ij[1]))
    acc = None
    for i, j in passes:
        t = (pa[i].double() @ pb[j].double()).float()
        acc = t if acc is None else acc + t
    return acc


def live_mask(S, T, causal, window):
    qpos = torch.arange(S)[:, None] + (T - S)
    kpos = torch.arange(T)[None, :]
    ok = torch.ones(S, T, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def backward64(q, k, v, dout, ok, cap):
    """One head's forward and backward in float64: (o, lse, dq, dk, dv)."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    s = q @ k.T / math.sqrt(q.shape[1])
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    s = s.masked_fill(~ok, -math.inf)
    lse = torch.logsumexp(s, dim=1)
    p = torch.where(ok.any(1, keepdim=True), torch.softmax(s, dim=1),
                    torch.zeros_like(s))
    o = p @ v
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), dout)
    return o.detach(), lse.detach(), dq, dk, dv


def split_backward(q, k, v, dout, o, lse, ok, cap, pieces):
    """One head's backward as flash_bwd_hopper forms it (f32 elementwise
    work, every product through ``split_product``)."""
    scale = np.float32(1.0 / math.sqrt(q.shape[1]))
    dsum = (dout * o).sum(1)
    x = split_product(q, k.T, pieces) * scale
    th = torch.tanh(x / cap) if cap is not None else None
    sc = cap * th if cap is not None else x
    p = torch.where(ok, torch.exp(sc - lse[:, None]), torch.zeros_like(sc))
    dp = split_product(dout, v.T, pieces)
    ds = p * (dp - dsum[:, None])
    if cap is not None:
        ds = ds * (1 - th * th)
    dv = split_product(p.T, dout, pieces)
    dk = split_product(ds.T, q, pieces) * scale
    dq = split_product(ds, k, pieces) * scale
    return dq, dk, dv


def worst_errors(case, pieces):
    """{gradient: max |error| over max |float64 gradient|} across the case's
    heads (GQA: a KV head's dK and dV summed over its group in head order)."""
    _, (B, S, T, H, K, hd), causal, window, cap = case
    rng = np.random.default_rng(S + T + hd)
    q, dout = (torch.from_numpy(rng.standard_normal((B, S, H, hd))
                                .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, hd))
                             .astype(np.float32)) for _ in range(2))
    ok = live_mask(S, T, causal, window)
    G = H // K
    got = {n: [] for n in ("dq", "dk", "dv")}
    want = {n: [] for n in ("dq", "dk", "dv")}
    for b in range(B):
        for kh in range(K):
            kk, vv = k[b, :, kh], v[b, :, kh]
            gk = torch.zeros(T, hd)
            gv = torch.zeros(T, hd)
            wk = torch.zeros(T, hd, dtype=torch.float64)
            wv = torch.zeros(T, hd, dtype=torch.float64)
            for h in range(kh * G, (kh + 1) * G):
                qq, dd = q[b, :, h], dout[b, :, h]
                o, lse, dq64, dk64, dv64 = backward64(qq, kk, vv, dd, ok, cap)
                dq, dk, dv = split_backward(qq, kk, vv, dd, o.float(),
                                            lse.float(), ok, cap, pieces)
                got["dq"].append(dq)
                want["dq"].append(dq64)
                gk, gv = gk + dk, gv + dv
                wk, wv = wk + dk64, wv + dv64
            got["dk"].append(gk)
            got["dv"].append(gv)
            want["dk"].append(wk)
            want["dv"].append(wv)
    out = {}
    for n in got:
        a, w = torch.stack(got[n]).double(), torch.stack(want[n])
        out[n] = float((a - w).abs().max()) / float(w.abs().max())
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_two_bf16_pieces_keep_the_backward_within_bwd_rtol(case):
    """The kernel's choice: two bf16 pieces, three passes a product."""
    errs = worst_errors(case, 2)
    print(case[0], "two pieces:", {n: f"{e:.3g}" for n, e in errs.items()})
    assert all(math.isfinite(e) for e in errs.values())
    assert max(errs.values()) <= BWD_RTOL, errs


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_one_bf16_piece_fails_bwd_rtol(case):
    """One piece fewer (each operand rounded to bf16 once) lands above
    BWD_RTOL: the margin the design keeps is the second piece."""
    errs = worst_errors(case, 1)
    print(case[0], "one piece:", {n: f"{e:.3g}" for n, e in errs.items()})
    assert max(errs.values()) > BWD_RTOL, errs
