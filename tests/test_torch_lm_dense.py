"""Port parity: the dense-attention serving path (block kinds ``attn``,
``local``, ``global``; granite-8b, gemma-7b, gemma3-27b, qwen1.5-32b)
against the JAX reference, on the CPU at the reduced sizes.

The reference's parameters (``repro.models.init_params``, f32) are carried
into the port with ``repro_torch.models.convert``, and the same numpy tokens
go through both packages. The tolerances are those of
tests/test_torch_lm_serve.py, each with its reason:

* one attention layer: 1e-5 of the output's scale — f32 both sides, the
  same formulas, sums in other orders (the port's train/prefill attention
  is the plain flash version; the reference's is ``_sdpa`` or
  ``_banded_sdpa``);
* the whole model: logits within 1e-4 of their scale, caches within 1e-4
  of each leaf's scale, greedy tokens equal;
* the port's decode against its own train-mode forward: 2e-3 of the
  logits' scale, the reference's own pin (tests/test_serve_decode.py:54);
* the plain flash version at hd 256 and with a soft-cap: the reference's
  kernel tolerance, rtol = atol = 2e-4 (tests/test_kernel_flash_attention.py).

The kernel itself runs only on the card (tests/test_torch_lm_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import applicable as ref_applicable
from repro.configs import get_config as ref_config
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import init_params as ref_init
from repro.models.layers import AttnSpec as RefSpec
from repro.models.layers import KVCache as RefKV
from repro.models.layers import _sdpa as ref_sdpa
from repro.models.layers import _train_mask as ref_train_mask
from repro.models.layers import attention as ref_attention
from repro.models.layers import init_attention as ref_init_attention
from repro.models.layers import layernorm as ref_layernorm
from repro.models.layers import rope_tables as ref_rope
from repro.models.model import make_caches as ref_make_caches
from repro.models.model import rolling_map as ref_rolling_map
from repro.serve.serve_step import _pad_kv as ref_pad_kv
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import greedy_generate as ref_greedy
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import forward, init_params, make_caches, rolling_map
from repro_torch.models.convert import (caches_from_numpy, params_from_numpy,
                                        params_to_numpy, to_numpy)
from repro_torch.models.layers import (AttnSpec, KVCache, _sdpa, _train_mask,
                                       attention, layernorm, rope_tables)
from repro_torch.models.model import apply_block, init_block, BlockIO
from repro_torch.serve.serve_step import (_pad_kv, decode_step,
                                          greedy_generate, pad_caches,
                                          prefill)
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_lm_cuda import TOL, qkv_inputs, tt

DENSE = ["granite-8b", "gemma-7b", "gemma3-27b", "qwen1.5-32b"]
B, NEW = 2, 8                  # batch, teacher-forced decode steps


def scale_of(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale_of(want), (err, scale_of(want))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


# --------------------------------------------------------- one attention
def layer(spec_kw, seed):
    """One attention layer's parameters in both packages, with random
    biases and qk-norm weights where the spec has them (the reference
    initialises them to 0 and 1)."""
    rspec = RefSpec(**spec_kw)
    spec = AttnSpec(**spec_kw)
    tree = np_tree(ref_init_attention(jax.random.PRNGKey(seed), rspec))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in tree:
            base = 1.0 if name.endswith("norm") else 0.0
            tree[name] = (base + 0.3 * rng.standard_normal(
                tree[name].shape)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in tree.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return rspec, spec, rp, p


def tables(spec, positions):
    pos = np.asarray(positions)
    return (ref_rope(jnp.asarray(pos), spec.head_dim, spec.rope_base),
            rope_tables(torch.from_numpy(pos), spec.head_dim, spec.rope_base))


BASE = dict(d_model=48, n_heads=4, n_kv=2, head_dim=16)
LAYER_CASES = {
    "gqa_qkv_bias": (dict(BASE, qkv_bias=True), 40),
    "qk_norm": (dict(BASE, qk_norm=True, rope_base=1e6), 40),
    "softcap": (dict(BASE, n_kv=4, softcap=2.0), 40),
    "window_masked": (dict(BASE, window=16), 40),       # 40 % 16 ≠ 0: _sdpa
    "window_banded": (dict(BASE, window=32, qk_norm=True), 64),  # S = 2W
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_attention_prefill_matches_reference(case):
    kw, S = LAYER_CASES[case]
    rspec, spec, rp, p = layer(kw, seed=len(case))
    x = np.random.default_rng(S).standard_normal((B, S, spec.d_model))
    x = x.astype(np.float32)
    (rc, rs), (c, s) = tables(spec, np.arange(S))
    rout, rkv = ref_attention(rp, jnp.asarray(x), rspec, cos=rc, sin=rs,
                              update_cache=True)
    n0 = FK.flash_attention.launches
    out, kv = attention(p, torch.from_numpy(x), spec, cos=c, sin=s,
                        update_cache=True)
    assert FK.flash_attention.launches == n0       # the plain version here
    close(out.numpy(), rout, 1e-5)
    close(kv.k.numpy(), rkv.k, 1e-5)
    close(kv.v.numpy(), rkv.v, 1e-5)
    assert kv.pos == int(rkv.pos) == S


def decode_both(rspec, spec, rp, p, x, rcache, cache, start, rolling):
    """Decode x[:, start:] token by token in both packages; each step's
    outputs within 1e-5 of their scale. Returns the final caches."""
    for t in range(start, x.shape[1]):
        (rc, rs), (c, s) = tables(spec, [t])
        rout, rcache = ref_attention(rp, jnp.asarray(x[:, t:t + 1]), rspec,
                                     cos=rc, sin=rs, cache=rcache,
                                     rolling=rolling)
        out, cache = attention(p, torch.from_numpy(x[:, t:t + 1]), spec,
                               cos=c, sin=s, cache=cache, rolling=rolling)
        close(out.numpy(), rout, 1e-5)
        assert cache.pos == int(rcache.pos) == t + 1
    return rcache, cache


def test_attention_decode_into_full_cache_matches_reference():
    rspec, spec, rp, p = layer(dict(BASE, qkv_bias=True, softcap=3.0), 5)
    x = np.random.default_rng(9).standard_normal((B, 28, spec.d_model))
    x = x.astype(np.float32)
    (rc, rs), _ = tables(spec, np.arange(20))
    _, rkv = ref_attention(rp, jnp.asarray(x[:, :20]), rspec, cos=rc,
                           sin=rs, update_cache=True)
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 8), (0, 0), (0, 0)))
    rcache = RefKV(jnp.asarray(pad(rkv.k)), jnp.asarray(pad(rkv.v)),
                   jnp.asarray(20, jnp.int32))
    cache = KVCache(torch.from_numpy(pad(rkv.k)),
                    torch.from_numpy(pad(rkv.v)), 20)
    rcache, cache = decode_both(rspec, spec, rp, p, x, rcache, cache, 20,
                                False)
    close(cache.k.numpy(), rcache.k, 1e-5)
    with pytest.raises(ValueError, match="full"):
        attention(p, torch.from_numpy(x[:, :1]), spec, cos=c_one(spec),
                  sin=c_one(spec), cache=cache)


def c_one(spec):
    return torch.ones(1, spec.head_dim // 2)


@pytest.mark.parametrize("S0", [5, 20])
def test_attention_decode_into_rolling_cache_matches_reference(S0):
    """A window-8 rolling cache: the prefill's keys kept in wrap-aligned
    slots (the reference's ``_pad_kv``), then decode past the wrap (from
    pos 20 the writes go to slots 4..7, then 0, 1, ...)."""
    W = 8
    rspec, spec, rp, p = layer(dict(BASE, window=W, qk_norm=True), 6)
    x = np.random.default_rng(S0).standard_normal((B, S0 + 14, spec.d_model))
    x = x.astype(np.float32)
    (rc, rs), _ = tables(spec, np.arange(S0))
    _, rkv = ref_attention(rp, jnp.asarray(x[:, :S0]), rspec, cos=rc,
                           sin=rs, update_cache=True)
    stacked = RefKV(rkv.k[None], rkv.v[None], rkv.pos)
    want = ref_pad_kv(stacked, W, True)
    kv = KVCache(torch.from_numpy(np.array(rkv.k)),
                 torch.from_numpy(np.array(rkv.v)), S0)
    got = _pad_kv(kv, W, True)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k[0]))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v[0]))
    rcache = RefKV(want.k[0], want.v[0], jnp.asarray(S0, jnp.int32))
    rcache, cache = decode_both(rspec, spec, rp, p, x, rcache, got, S0, True)
    close(cache.k.numpy(), rcache.k, 1e-5)
    close(cache.v.numpy(), rcache.v, 1e-5)


def test_train_mask_and_layernorm_match_reference():
    q = np.arange(6)
    k = np.array([-3, 0, 1, 2, 5, 7])
    valid = np.random.default_rng(0).random((2, 6)) > 0.3
    for window in (None, 3):
        want = ref_train_mask(jnp.asarray(q), jnp.asarray(k), causal=True,
                              window=window)
        got = _train_mask(torch.from_numpy(q), torch.from_numpy(k),
                          causal=True, window=window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = ref_train_mask(jnp.asarray(q), jnp.asarray(k), causal=True,
                              window=window, valid=jnp.asarray(valid))
        got = _train_mask(torch.from_numpy(q), torch.from_numpy(k),
                          causal=True, window=window,
                          valid=torch.from_numpy(valid))
        assert got.shape == (2, 6, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x, w, b = (np.random.default_rng(i).standard_normal(s).astype(np.float32)
               for i, s in ((1, (3, 5, 32)), (2, (32,)), (3, (32,))))
    close(layernorm(*map(torch.from_numpy, (x, w, b))).numpy(),
          ref_layernorm(*map(jnp.asarray, (x, w, b))), 1e-6)


# ------------------------------------------------- plain flash, hd 256, cap
@pytest.mark.parametrize("B_,S,H,K,hd,window", [
    (1, 128, 2, 2, 256, None),       # gemma-7b's head width, MHA
    (2, 128, 4, 2, 256, 64),         # GQA and a window at hd 256
])
def test_plain_flash_hd256_matches_reference_kernel(B_, S, H, K, hd, window):
    q, k, v = qkv_inputs(B_, S, S, H, K, hd, seed=hd + S)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_k = ref_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                       block_k=64, interpret=True)
    want_o = attention_ref(jq, jk, jv, causal=True, window=window)
    got = flash_attention(*tt((q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_o), **TOL)


@pytest.mark.parametrize("hd,cap,window", [(64, 5.0, None), (256, 2.0, 48),
                                           (128, 1.0, None)])
def test_plain_flash_softcap_matches_reference_sdpa(hd, cap, window):
    """The soft-cap against the reference's ``_sdpa(softcap=)`` under the
    same causal (and window) mask; a cap of 1 bends every score."""
    S, H, K = 96, 4, 2
    q, k, v = qkv_inputs(2, S, S, H, K, hd, seed=hd)
    pos = jnp.arange(S)
    mask = ref_train_mask(pos, pos, causal=True, window=window)
    want = ref_sdpa(*map(jnp.asarray, (q, k, v)), mask, softcap=cap)
    got = flash_attention(*tt((q, k, v)), causal=True, window=window,
                          softcap=cap)
    np.testing.assert_allclose(got.reshape(2, S, H * hd).numpy(),
                               np.asarray(want), **TOL)
    tmask = _train_mask(torch.arange(S), torch.arange(S), causal=True,
                        window=window)
    np.testing.assert_allclose(
        _sdpa(*tt((q, k, v)), tmask, softcap=cap).numpy(), np.asarray(want),
        **TOL)
    uncapped = flash_attention(*tt((q, k, v)), causal=True, window=window)
    assert float((uncapped - got).abs().max()) > 1e-3   # the cap bites


def test_flash_wrapper_checks_head_width_and_softcap():
    """The kernel takes hd ∈ {16, 32, 64, 128, 256}; the wrapper's check
    (``check_kernel_args``, run for CUDA tensors before the library is
    asked) says so for any other width, and a soft-cap must be > 0."""
    assert FK.HEAD_WIDTHS == (16, 32, 64, 128, 256)
    for hd in FK.HEAD_WIDTHS:
        FK.check_kernel_args(*tt(qkv_inputs(1, 8, 8, 2, 1, hd)))
    for hd in (8, 48, 96, 192, 512):
        with pytest.raises(ValueError, match="head width"):
            FK.check_kernel_args(*tt(qkv_inputs(1, 8, 8, 2, 1, hd)))
    q, k, v = tt(qkv_inputs(1, 8, 8, 2, 1, 16))
    with pytest.raises(TypeError):
        FK.check_kernel_args(q.double(), k, v)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, k, v, softcap=0.0)
    # the plain version takes any width on the CPU
    assert flash_attention(*tt(qkv_inputs(1, 8, 8, 2, 1, 48))).shape == \
        (1, 8, 2, 48)


# ------------------------------------------------------- the whole models
SERVE_CASES = [("granite-8b", 40), ("gemma-7b", 40), ("gemma3-27b", 40),
               ("gemma3-27b", 64), ("qwen1.5-32b", 40)]
SERVE_IDS = [f"{a}-{s}" for a, s in SERVE_CASES]


def configs(arch):
    return (dataclasses.replace(ref_config(arch, reduced=True),
                                dtype=jnp.float32),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype=torch.float32))


@pytest.fixture(scope="module", params=SERVE_CASES, ids=SERVE_IDS)
def served(request):
    """One reduced dense model in both packages from one set of
    parameters: the reference's prefill of S0 tokens + 8 teacher-forced
    decode steps and greedy generation, and the port's."""
    arch, S0 = request.param
    S = S0 + NEW
    rcfg, cfg = configs(arch)
    rparams = ref_init(rcfg, jax.random.PRNGKey(1))
    tree = np_tree(rparams)
    params = params_from_numpy(tree)
    tokens = np.random.default_rng(S0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)

    rlog, rcaches, rrolling = ref_prefill(rparams, rcfg,
                                          jnp.asarray(tokens[:, :S0]),
                                          cache_len=S)
    ref_steps = [np.asarray(rlog)]
    pos = jnp.asarray(S0, jnp.int32)
    for t in range(S0, S):
        if t == S - 1:                 # the caches the last step reads
            ref_before_last = np_tree(rcaches)
        lg, rcaches = ref_decode(rparams, rcfg,
                                 jnp.asarray(tokens[:, t:t + 1]), rcaches,
                                 pos, rolling=rrolling)
        ref_steps.append(np.asarray(lg))
        pos = pos + 1
    ref_tokens = np.asarray(ref_greedy(rparams, rcfg,
                                       jnp.asarray(tokens[:, :S0]), n_new=NEW))

    tok = torch.from_numpy(tokens).long()
    n0 = FK.flash_attention.launches
    lg, caches, rolling = prefill(params, cfg, tok[:, :S0], cache_len=S)
    steps = [lg.numpy()]
    for t in range(S0, S):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t,
                                 rolling=rolling)
        steps.append(lg.numpy())
    greedy = greedy_generate(params, cfg, tok[:, :S0], n_new=NEW)
    assert FK.flash_attention.launches == n0       # no kernel on the CPU
    return dict(arch=arch, S0=S0, S=S, rcfg=rcfg, cfg=cfg, tree=tree,
                rparams=rparams,
                params=params, tokens=tokens, ref_steps=ref_steps,
                ref_caches=np_tree(rcaches), ref_rolling=rrolling,
                ref_before_last=ref_before_last,
                ref_tokens=ref_tokens, steps=steps, caches=to_numpy(caches),
                port_caches=caches, rolling=rolling, greedy=greedy.numpy())


def test_dense_rolling_map_matches_reference(served):
    assert served["rolling"] == served["ref_rolling"]
    assert served["rolling"] == ref_rolling_map(served["rcfg"], served["S"])
    assert rolling_map(served["cfg"], served["S"]) == served["rolling"]
    if served["arch"] == "gemma3-27b":          # reduced window 32 < S
        assert served["rolling"] == {"local": True, "global": False}


def test_dense_prefill_logits_match_reference(served):
    close(served["steps"][0], served["ref_steps"][0], 1e-4)


def test_dense_teacher_forced_decode_matches_reference(served):
    scale = scale_of(served["ref_steps"][0])
    for t, (got, want) in enumerate(zip(served["steps"][1:],
                                        served["ref_steps"][1:])):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (t, err, scale)


def test_dense_decode_caches_match_reference(served):
    want, want_def = jax.tree.flatten(served["ref_caches"])
    got, got_def = jax.tree.flatten(served["caches"])
    n_layers = served["cfg"].n_layers
    assert len(got) == len(want) == 3 * n_layers
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.ndim == 0:                          # KVCache.pos
            assert int(g) == int(w) == served["S"]
        else:
            close(g, w, 1e-4)
    if served["rolling"].get("local"):           # window-sized local caches
        W = served["cfg"].local_window
        assert served["caches"][0][0][0].k.shape[1] == W
        assert served["caches"][0][-1][0].k.shape[1] == served["S"]


def test_dense_greedy_tokens_match_reference(served):
    assert served["greedy"].shape == (B, NEW)
    np.testing.assert_array_equal(served["greedy"], served["ref_tokens"])


def test_dense_decode_matches_own_train_forward(served):
    full = forward(served["params"], served["cfg"],
                   torch.from_numpy(served["tokens"]).long()).logits.numpy()
    scale = max(scale_of(full), 1.0)
    for t, got in zip(range(served["S0"] - 1, served["S"]), served["steps"]):
        assert np.abs(got - full[:, t]).max() < 2e-3 * scale, t


def test_dense_decode_from_reference_caches(served):
    """The reference's caches before the last teacher-forced step, carried
    into the port (``caches_from_numpy``), give the port's step the
    reference's logits; carried back (``to_numpy``) they are the same
    leaves."""
    cfg, S = served["cfg"], served["S"]
    caches = caches_from_numpy(cfg, served["ref_before_last"])
    back = jax.tree.leaves(to_numpy(caches))
    want = jax.tree.leaves(served["ref_before_last"])
    assert len(back) == len(want) == 3 * cfg.n_layers
    for g, w in zip(back, want):
        np.testing.assert_array_equal(g, w)
    tok = torch.from_numpy(served["tokens"][:, S - 1:]).long()
    got, _ = decode_step(served["params"], cfg, tok, caches, S - 1,
                         rolling=served["rolling"])
    close(got.numpy(), served["ref_steps"][-1], 1e-4)


def test_dense_convert_round_trips_every_leaf(served):
    back = params_to_numpy(served["params"])
    want, want_def = jax.tree.flatten(served["tree"])
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    # the dense trees' own leaves arrive
    layer0 = served["params"]["segments"][0][0][0]
    cfg = served["cfg"]
    assert set(layer0) == {"ln1", "ln2", "attn", "ffn"}
    assert ("q_norm" in layer0["attn"]) == cfg.qk_norm
    assert ("bq" in layer0["attn"]) == cfg.qkv_bias
    assert ("head" in served["params"]) == (not cfg.tie_embeddings)
    segs = [[len(pos) for pos in seg] for seg in served["params"]["segments"]]
    if served["arch"] == "gemma3-27b":         # a 5:1 period, 2 local left
        assert segs == [[1] * 6, [1, 1]]
    else:
        assert segs == [[cfg.n_layers]]


def test_dense_init_and_make_caches_match_reference(served):
    cfg, rcfg, S = served["cfg"], served["rcfg"], served["S"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, params_to_numpy(params))
    assert got == jax.tree.map(np.shape, served["tree"])
    if cfg.rms_plus_one:                       # (1 + w) norms start at 0
        assert not params["ln_f"].any()
        assert not params["segments"][0][0][0]["ln2"].any()
    want, rolling = ref_make_caches(rcfg, B, S, stacked=False)
    got, rolling_p = make_caches(cfg, B, S, device="cpu")
    assert rolling_p == rolling
    want = jax.tree.leaves(np_tree(want))
    got = jax.tree.leaves(to_numpy(got))
    assert len(got) == len(want) == 3 * cfg.n_layers
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert not np.any(g) and not np.any(w)


@pytest.mark.parametrize("S0", [32, 40])
def test_rolling_cache_matches_full_cache(S0):
    """gemma3's local layers decoding with rolling (window-sized) caches
    equal the same decode with full caches, whose mask holds the window
    (the reference's tests/test_serve_decode.py:65), within 2e-3."""
    _, cfg = configs("gemma3-27b")
    params = init_params(cfg, torch.Generator().manual_seed(3))
    S = S0 + 24
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)))
    full_logits = forward(params, cfg, tokens).logits
    _, caches, rolling = prefill(params, cfg, tokens[:, :S0], cache_len=S)
    assert rolling == {"local": True, "global": False}
    res = forward(params, cfg, tokens[:, :S0], mode="prefill")
    full = pad_caches(cfg, res.caches, S, {})
    scale = max(scale_of(full_logits), 1.0)
    for t in range(S0, S):
        a, caches = decode_step(params, cfg, tokens[:, t:t + 1], caches, t,
                                rolling=rolling)
        b, full = decode_step(params, cfg, tokens[:, t:t + 1], full, t,
                              rolling={})
        assert float((a - b).abs().max()) < 1e-5 * scale, t
        assert float((a - full_logits[:, t]).abs().max()) < 2e-3 * scale, t


def test_attention_block_kinds_use_their_tables_and_windows():
    """``global`` layers read the long-base RoPE tables, ``local`` ones the
    window: the block output of each kind changes with its own knob only."""
    _, cfg = configs("gemma3-27b")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 48, cfg.d_model, generator=gen)
    from repro_torch.models.model import _rope_for
    rope = _rope_for(cfg, torch.arange(48))
    assert not torch.equal(rope["global"][0], rope["default"][0])
    io = BlockIO(cfg=cfg, mode="train", rope=rope)
    for kind in ("local", "global"):
        p = init_block(gen, cfg, kind)
        y, _ = apply_block(p, x, kind, io, None)
        wide = dataclasses.replace(cfg, local_window=4096)
        mine, other = (("global", "default") if kind == "global"
                       else ("default", "global"))
        swapped = dict(rope, **{mine: rope[other]})
        y_wide, _ = apply_block(p, x, kind, dataclasses.replace(io, cfg=wide),
                                None)
        y_swap, _ = apply_block(p, x, kind,
                                dataclasses.replace(io, rope=swapped), None)
        if kind == "local":
            assert not torch.allclose(y, y_wide) and not torch.allclose(
                y, y_swap)
        else:
            assert torch.equal(y, y_wide) and not torch.allclose(y, y_swap)


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_and_shapes_match_reference(arch):
    for reduced in (False, True):
        ref = dataclasses.asdict(ref_config(arch, reduced=reduced))
        got = dataclasses.asdict(get_config(arch, reduced=reduced))
        ref.pop("dtype"), got.pop("dtype")
        assert got == ref
        assert get_config(arch, reduced=reduced).n_params() == \
            ref_config(arch, reduced=reduced).n_params()
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES:
        assert applicable(cfg, shape) == ref_applicable(rcfg, shape)


@pytest.mark.parametrize("arch,item", [
    ("mixtral-8x7b", "13d"), ("mixtral-8x22b-reduced", "13d"),
    ("seamless-m4t-large-v2", "13c"), ("internvl2-2b", "13c")])
def test_later_architectures_raise_naming_their_item(arch, item):
    """The architectures of items 13c and 13d, which raised naming their
    item until each was ported, resolve to the reference's
    configurations."""
    got, want = (dataclasses.asdict(f(arch)) for f in (get_config,
                                                        ref_config))
    got.pop("dtype"), want.pop("dtype")
    assert got == want


@pytest.mark.parametrize("kind,item", [("moe", "13d"), ("dec", "13c"),
                                       ("enc", "13c")])
def test_later_block_kinds_raise_naming_their_item(kind, item):
    """``moe`` (item 13d), ``enc`` and ``dec`` (item 13c), which raised
    naming their item until each was ported, initialise with the
    reference's shapes (``dec``: its ``ln_x`` and ``xattn`` too; ``moe``:
    mixtral's router and stacked experts)."""
    from repro.models.model import init_block as ref_init_block
    rcfg, cfg = configs("mixtral-8x7b" if kind == "moe" else "granite-8b")
    got = init_block(torch.Generator().manual_seed(0), cfg, kind)
    want = ref_init_block(jax.random.PRNGKey(0), rcfg, kind)
    assert jax.tree.map(np.shape, to_numpy(got)) == \
        jax.tree.map(np.shape, np_tree(want))
    assert ("router" in got["ffn"]) == (kind == "moe")
    assert ("xattn" in got) == (kind == "dec")
