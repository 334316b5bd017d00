"""Port parity in bf16, the reference's default dtype, on the CPU at the
reduced sizes.

The reference runs in its own default dtype (bf16: no ``dtype=`` override)
from ``repro.models.init_params``; its parameters are carried into the port
bit for bit by ``repro_torch.models.convert``, and the same numpy tokens go
through both packages. Tolerances, each with its reason:

* the plain flash attention against the Pallas kernel in interpret mode.
  Both round the unnormalised P to V's dtype before P·V and the output
  once, but the kernel rounds P against the running maximum of its 128-key
  tiles and the plain version against the row's maximum. Read before the
  output's rounding (q given as f32 holding bf16 values, k and v bf16, so
  the output stays f32) the two are within 2e-3 of the output's scale;
  where every row's keys lie in one tile (the same maximum) their RMS
  difference is within 1e-5 of the scale (a P whose score differs by an
  f32 ulp may round to the other neighbour and move one row a little).
  The RMS check tells the rounding of P from its absence: a control test
  asserts that P kept in f32 is more than 5 times the tolerance away. On
  bf16 outputs the check is 2e-3 of the scale beyond one bf16 rounding of
  each value (2^-7 of it), since an output may round to the neighbouring
  bf16 value: one step at 1.0 is 6.8e-3 of a 1.15 scale;
* the plain scans against their Pallas kernels on bf16 u, B and C: both
  compute in f32 from the same bf16 inputs and round y once, so y is within
  one bf16 rounding of the kernel's (2^-7 of each value) plus the f32 pin of
  2e-4 of the scale; the f32 state within 2e-4;
* the models: two bf16 runs round at different places (PyTorch rounds after
  every op, XLA inside its fusions), so the port is held to the reference's
  bf16 run within twice the reference's own bf16-vs-f32 distance, at every
  step (the prefill and 8 teacher-forced decode steps). A distance is the
  RMS of a step's logits difference over 8 prompts, as a share of the f32
  logits' RMS. Over 2 prompts, or as a maximum, the ratio of two
  independent bf16 roundings' distances fluctuates past 2 for the chaotic
  zamba2-reduced and falcon-reduced (probe: up to 2.15); over 8 prompts its
  RMS stayed at or under 1.46 for every model and five token seeds. Greedy
  tokens are compared within the port only, run twice: in bf16 an argmax
  tie or flip against another library's rounding is not a fault.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_config
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.mamba_scan import selective_scan as ref_sel
from repro.kernels.ssd_scan import ssd_scan as ref_ssd
from repro.models import init_params as ref_init
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import selective_scan
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.convert import (caches_from_numpy, leaves,
                                        params_from_numpy, params_to_numpy,
                                        to_numpy)
from repro_torch.serve.serve_step import decode_step, greedy_generate, \
    prefill
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_lm_cuda import (FLASH_BF16_RTOL, qkv_inputs, scan_inputs,
                                ssd_inputs, within_bf16_rounding)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S0, NEW = 8, 40, 8
F32_RTOL = 2e-4            # the f32 kernels' pin (tests/test_kernel_*.py)
RATIO = 2.0                # the port's bf16 distance / the reference's own
FLASH_F32_OUT_RTOL = 2e-3  # plain vs Pallas flash, f32 outputs, of the scale
ONE_TILE_RMS_RTOL = 1e-5   # their RMS difference where keys lie in one tile
PALLAS_BLOCK_K = 128       # the Pallas flash kernel's key tile


def bits(a) -> np.ndarray:
    """A numpy leaf as comparable bits: bf16 as its uint16 patterns."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def bf16_pair(a: np.ndarray):
    """An f32 array rounded to bf16 once, as (jax array, torch tensor) with
    the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(bits(j).copy()).view(torch.bfloat16)
    return j, t


def rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


def widened(x) -> torch.Tensor:
    """A jax array as an f32 tensor (each bf16 value widened exactly)."""
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32)))


# --------------------------------------------------- (b) flash attention
@pytest.mark.parametrize("Bq,S,T,H,K,hd,window", [
    (1, 128, 128, 4, 4, 64, None),
    (1, 256, 256, 4, 2, 128, None),      # GQA, two KV tiles
    (1, 256, 256, 4, 4, 64, 100),        # window
    (1, 128, 256, 4, 1, 64, None),       # T ≠ S, GQA 4:1
    (1, 128, 128, 2, 2, 256, None),
    (1, 128, 256, 2, 1, 256, 96),        # hd 256, T ≠ S, window
])
def test_plain_flash_bf16_matches_reference_kernel(Bq, S, T, H, K, hd, window):
    q, k, v = (bf16_pair(a) for a in qkv_inputs(Bq, S, T, H, K, hd,
                                                seed=S + T + hd))
    want = ref_flash(q[0], k[0], v[0], window=window, interpret=True)
    got = flash_attention(q[1], k[1], v[1], window=window)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    within_bf16_rounding(got, widened(want), FLASH_BF16_RTOL)
    # the outputs before their rounding: q in f32 (its bf16 values), k and v
    # bf16, so both round P to bf16 and return f32
    want32 = widened(ref_flash(q[0].astype(jnp.float32), k[0], v[0],
                               window=window, interpret=True))
    got32 = flash_attention_ref(q[1].float(), k[1], v[1], window=window)
    assert got32.dtype == torch.float32
    scale = float(want32.abs().max())
    err = float((got32 - want32).abs().max())
    assert err <= FLASH_F32_OUT_RTOL * scale, err
    if T <= PALLAS_BLOCK_K:
        assert rms(got32 - want32) <= ONE_TILE_RMS_RTOL * scale


@pytest.mark.parametrize("H,K,hd", [(4, 4, 64), (4, 2, 128), (2, 2, 256)])
def test_plain_flash_check_catches_unrounded_p(H, K, hd):
    """Control of the check above: attention with P kept in f32 (the plain
    softmax on the widened inputs, the rounding left out) is far outside the
    one-tile RMS tolerance of the Pallas kernel, which rounds P, while the
    plain version is inside it."""
    q, k, v = (bf16_pair(a) for a in qkv_inputs(1, 128, 128, H, K, hd,
                                                seed=256 + hd))
    want = widened(ref_flash(q[0].astype(jnp.float32), k[0], v[0],
                             interpret=True))
    limit = ONE_TILE_RMS_RTOL * float(want.abs().max())
    rounded = flash_attention_ref(q[1].float(), k[1], v[1])
    unrounded = flash_attention_ref(q[1].float(), k[1].float(), v[1].float())
    assert rms(rounded - want) <= limit
    assert rms(unrounded - want) > 5 * limit


def test_plain_flash_f32_is_unchanged():
    """For f32 inputs the plain version is the normalised softmax times V,
    as before bf16 came in (its P is not rounded), bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in qkv_inputs(1, 64, 64, 4, 2, 32))
    got = flash_attention(q, k, v, window=20)
    qg = q.reshape(1, 64, 2, 2, 32)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k) / np.sqrt(32.0)
    i = torch.arange(64)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 20)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    want = torch.einsum("bkgst,btkh->bskgh", p, v).reshape(1, 64, 4, 32)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ------------------------------------------------------------ (c) scans
@pytest.mark.parametrize("Bz,S,H,hp,N", [(2, 64, 2, 16, 8), (1, 128, 3, 32, 16)])
def test_plain_ssd_bf16_matches_reference_kernel(Bz, S, H, hp, N):
    u, dt, A, Bm, Cm, D = ssd_inputs(Bz, S, H, hp, N, seed=S + hp)
    (uj, ut), (bj, bt), (cj, ct) = map(bf16_pair, (u, Bm, Cm))
    y_k, h_k = ref_ssd(uj, jnp.asarray(dt), jnp.asarray(A), bj, cj,
                       jnp.asarray(D), chunk=32, interpret=True)
    y, h = ssd_scan(ut, torch.from_numpy(dt), torch.from_numpy(A), bt, ct,
                    torch.from_numpy(D), chunk=32)
    assert y.dtype == torch.bfloat16 and y_k.dtype == jnp.bfloat16
    assert h.dtype == torch.float32
    within_bf16_rounding(y, widened(y_k), F32_RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_k), rtol=F32_RTOL,
                               atol=F32_RTOL)


@pytest.mark.parametrize("Bz,S,dI,N,with_h0", [(2, 40, 64, 8, False),
                                               (1, 33, 128, 16, True)])
def test_plain_selective_scan_bf16_matches_reference_kernel(Bz, S, dI, N,
                                                            with_h0):
    u, dt, A, Bm, Cm, D = scan_inputs(Bz, S, dI, N, seed=S + dI)
    (uj, ut), (bj, bt), (cj, ct) = map(bf16_pair, (u, Bm, Cm))
    h0 = (np.random.default_rng(3).standard_normal((Bz, dI, N)).astype(
        np.float32) if with_h0 else None)
    y_k, h_k = ref_sel(uj, jnp.asarray(dt), jnp.asarray(A), bj, cj,
                       jnp.asarray(D),
                       h0=None if h0 is None else jnp.asarray(h0),
                       block_d=32, interpret=True)
    y, h = selective_scan(ut, torch.from_numpy(dt), torch.from_numpy(A), bt,
                          ct, torch.from_numpy(D),
                          h0=None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and y_k.dtype == jnp.bfloat16
    assert h.dtype == torch.float32
    within_bf16_rounding(y, widened(y_k), F32_RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_k), rtol=F32_RTOL,
                               atol=F32_RTOL)


# ----------------------------------------------------------- the models
ARCHS = ("granite-8b", "gemma-7b", "gemma3-27b", "qwen1.5-32b",
         "zamba2-1.2b", "falcon-mamba-7b")
CASES = [(a, False) for a in ARCHS] + [("zamba2-1.2b", True)]
IDS = ARCHS + ("zamba2-1.2b-ssm_bf16",)


def ref_run(rcfg, rparams, tokens):
    """The reference's prefill of S0 tokens and NEW − 1 … teacher-forced
    decode steps: (logits per step as f32, the caches after prefill)."""
    S = tokens.shape[1]
    lg, caches, rolling = ref_prefill(rparams, rcfg,
                                      jnp.asarray(tokens[:, :S0]),
                                      cache_len=S)
    after_prefill = jax.tree.map(np.asarray, caches)
    steps = [np.asarray(lg, np.float32)]
    pos = jnp.asarray(S0, jnp.int32)
    for t in range(S0, S):
        lg, caches = ref_decode(rparams, rcfg, jnp.asarray(tokens[:, t:t + 1]),
                                caches, pos, rolling=rolling)
        steps.append(np.asarray(lg, np.float32))
        pos = pos + 1
    return np.stack(steps), after_prefill


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def bf16_served(request):
    """One reduced model in both packages in bf16 from one set of
    parameters, and the reference in f32 on the same parameters (each bf16
    value widened exactly): the prefill + teacher-forced decode logits."""
    arch, ssm_bf16 = request.param
    rcfg = ref_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    assert rcfg.dtype == jnp.bfloat16 and cfg.dtype == torch.bfloat16
    if ssm_bf16:
        rcfg = dataclasses.replace(rcfg, ssm_bf16=True)
        cfg = dataclasses.replace(cfg, ssm_bf16=True)
    rparams = ref_init(rcfg, jax.random.PRNGKey(1))
    widen = lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x
    rcfg32 = dataclasses.replace(rcfg, dtype=jnp.float32, ssm_bf16=False)
    tokens = np.random.default_rng(S0).integers(
        0, cfg.vocab, (B, S0 + NEW)).astype(np.int32)
    ref16, ref_caches = ref_run(rcfg, rparams, tokens)
    ref32, _ = ref_run(rcfg32, jax.tree.map(widen, rparams), tokens)

    tree = jax.tree.map(np.asarray, rparams)
    params = params_from_numpy(tree)
    tok = torch.from_numpy(tokens).long()
    n0 = (FK.flash_attention.launches, SK.ssd_scan.launches)
    lg, caches, rolling = prefill(params, cfg, tok[:, :S0],
                                  cache_len=S0 + NEW)
    port_caches = caches
    steps = [lg]
    for t in range(S0, S0 + NEW):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t,
                                 rolling=rolling)
        steps.append(lg)
    greedy = [greedy_generate(params, cfg, tok[:, :S0], NEW)
              for _ in range(2)]
    assert (FK.flash_attention.launches, SK.ssd_scan.launches) == n0
    return dict(arch=arch, cfg=cfg, tree=tree, params=params,
                ref16=ref16, ref32=ref32, ref_caches=ref_caches,
                port_caches=to_numpy(port_caches),
                steps=steps, greedy=greedy)


def test_bf16_params_and_caches_cross_bit_for_bit(bf16_served):
    """(a) The reference's bf16 parameters into the port and back, and its
    prefill caches into the port and back, bit for bit; the port's bf16
    leaves are torch.bfloat16 and its f32 leaves (SSM A, D, dt_bias, norms
    the reference keeps in f32) stay f32."""
    s = bf16_served
    want = [bits(a) for a in jax.tree.leaves(s["tree"])]
    got = jax.tree.leaves(params_to_numpy(s["params"]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    dtypes = {t.dtype for t in leaves(s["params"])}
    assert torch.bfloat16 in dtypes and dtypes <= {torch.bfloat16,
                                                   torch.float32}
    port = caches_from_numpy(s["cfg"], s["ref_caches"])
    want = [bits(a) for a in jax.tree.leaves(s["ref_caches"])]
    got = [np.asarray(a) for a in jax.tree.leaves(to_numpy(port))]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):       # a KV cache's pos is a Python int
        assert (g.dtype == w.dtype or g.ndim == 0) and np.array_equal(g, w)


def test_bf16_serve_within_twice_the_references_own_bf16_error(bf16_served):
    """(d), (e) The port's bf16 prefill and teacher-forced decode logits
    against the reference's bf16 run, at every step within twice the
    reference's own bf16-vs-f32 distance (RMS over the 8 prompts, as a
    share of the f32 logits' RMS); the logits are bf16."""
    s = bf16_served
    port = np.stack([lg.float().numpy() for lg in s["steps"]])
    assert all(lg.dtype == torch.bfloat16 for lg in s["steps"])
    rms = lambda a: np.sqrt(np.mean(np.square(a), axis=(1, 2)))
    scale = rms(s["ref32"])
    mine = rms(port - s["ref16"]) / scale
    ref_own = rms(s["ref16"] - s["ref32"]) / scale
    print(s["arch"], "port/ref distance per step", np.round(mine / ref_own, 3))
    assert np.all(ref_own > 0)
    assert np.all(mine <= RATIO * ref_own), (mine, ref_own)


def test_bf16_greedy_tokens_equal_within_the_port(bf16_served):
    a, b = bf16_served["greedy"]
    assert a.shape == (B, NEW) and torch.equal(a, b)


def test_bf16_caches_hold_the_references_dtypes(bf16_served):
    """KV caches and conv states in bf16, SSM states in f32, as the
    reference's (its prefill caches, carried across bit for bit)."""
    got = [np.asarray(a) for a in jax.tree.leaves(bf16_served["port_caches"])]
    want = [bits(a) for a in jax.tree.leaves(bf16_served["ref_caches"])]
    assert [a.dtype for a in got if a.ndim] == \
        [a.dtype for a in want if a.ndim]


def test_port_carries_bf16_without_ml_dtypes():
    """(a) The port reads and writes bf16 leaves without importing
    ml_dtypes (numpy's bf16 comes from it, on the reference's side only)."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.models.convert import to_numpy\n"
        "a = to_numpy({'w': torch.arange(4.0).bfloat16()})['w']\n"
        "assert a.dtype == np.uint16, a.dtype\n"
        "assert 'ml_dtypes' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------- (f) CLI
def test_serve_cli_runs_in_bf16_on_cpu():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "gemma3-27b", "--reduced", "--batch", "2",
                    "--prompt-len", "40", "--new-tokens", "4", "--device",
                    "cpu", "--dtype", "bfloat16"])
    text = out.getvalue()
    assert "torch.bfloat16" in text and "sample tokens" in text
