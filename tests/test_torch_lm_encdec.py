"""Port parity: the enc-dec and VLM serving paths (block kinds ``enc`` and
``dec``, cross-attention, the patch prefix; seamless-m4t-large-v2 and
internvl2-2b) against the JAX reference, on the CPU at the reduced sizes.

The reference's parameters (``repro.models.init_params``, f32) are carried
into the port with ``repro_torch.models.convert``, and the same numpy
tokens, encoder inputs and patch embeddings go through both packages. The
encoder is 24 frames long against a prompt of 40 (cross-attention with
S ≠ T, fewer keys than queries), and in a second case 56 (more keys than
queries). The tolerances are those of tests/test_torch_lm_dense.py, each
with its reason:

* one attention layer: 1e-5 of the output's scale — f32 both sides, the
  same formulas, sums in other orders (the port's prefill attention is the
  plain flash version, the reference's ``_sdpa``);
* the encoder stack and the whole model: 1e-4 of the scale (logits,
  caches, the encoder's output), greedy tokens equal;
* the port's decode against its own train-mode forward: 2e-3 of the
  logits' scale, the reference's own pin (tests/test_serve_decode.py:54).

The kernel itself runs only on the card (tests/test_torch_lm_cuda.py).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init
from repro.models.layers import AttnSpec as RefSpec
from repro.models.layers import attention as ref_attention
from repro.models.layers import init_attention as ref_init_attention
from repro.models.model import BlockIO as RefBlockIO
from repro.models.model import _run_encoder as ref_run_encoder
from repro.models.model import forward as ref_forward
from repro.models.model import make_caches as ref_make_caches
from repro.models.model import rolling_map as ref_rolling_map
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import greedy_generate as ref_greedy
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import forward, init_params, make_caches, rolling_map
from repro_torch.models.convert import (caches_from_numpy, params_from_numpy,
                                        params_to_numpy, to_numpy)
from repro_torch.models.layers import AttnSpec, KVCache, attention
from repro_torch.models.model import BlockIO, _run_encoder, init_block
from repro_torch.serve.serve_step import (decode_step, greedy_generate,
                                          prefill)
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["seamless-m4t-large-v2", "internvl2-2b"]
B, S0, NEW = 2, 40, 8          # batch, prompt, teacher-forced decode steps


def scale_of(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale_of(want), (err, scale_of(want))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def configs(arch):
    return (dataclasses.replace(ref_config(arch, reduced=True),
                                dtype=jnp.float32),
            dataclasses.replace(get_config(arch, reduced=True),
                                dtype=torch.float32))


def frontend_inputs(cfg, enc_len: int, seed: int) -> dict:
    """The stub frontends' inputs, standard normal × 0.1 as the reference's
    launcher draws them, as numpy: ``enc_inputs`` (B, enc_len, d) for an
    enc-dec model, ``patch_embeds`` (B, P, d) for a VLM."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.is_encdec:
        out["enc_inputs"] = (0.1 * rng.standard_normal(
            (B, enc_len, cfg.d_model))).astype(np.float32)
    if cfg.vlm_patches:
        out["patch_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.vlm_patches, cfg.d_model))).astype(np.float32)
    return out


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_n_params_match_reference(arch):
    for reduced in (False, True):
        ref = dataclasses.asdict(ref_config(arch, reduced=reduced))
        got = dataclasses.asdict(get_config(arch, reduced=reduced))
        ref.pop("dtype"), got.pop("dtype")
        assert got == ref
        assert get_config(arch, reduced=reduced).n_params() == \
            ref_config(arch, reduced=reduced).n_params()
    assert get_config(arch + "-reduced").name == arch + "-reduced"
    cfg = get_config(arch)
    assert cfg.vocab_padded == ref_config(arch).vocab_padded


# --------------------------------------------------------- one attention
BASE = dict(d_model=48, n_heads=4, n_kv=2, head_dim=16)
CROSS_CASES = {
    "gqa-fewer-keys": (dict(BASE), 40, 24),
    "gqa-more-keys": (dict(BASE), 24, 56),
    "qk_norm-bias": (dict(BASE, n_kv=4, qk_norm=True, qkv_bias=True), 40, 24),
    "softcap": (dict(BASE, softcap=2.0), 33, 70),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_attention_prefill_and_decode_match_reference(case):
    """Cross-attention at prefill (k, v from ``kv_x``, no RoPE, no mask,
    through the flash op with S ≠ T) and at decode (the read-only cache),
    against the reference's ``attention(..., cross=True)``."""
    kw, S, T = CROSS_CASES[case]
    rspec, spec = RefSpec(**kw), AttnSpec(**kw)
    tree = np_tree(ref_init_attention(jax.random.PRNGKey(len(case)), rspec))
    rng = np.random.default_rng(S + T)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if name in tree:
            base = 1.0 if name.endswith("norm") else 0.0
            tree[name] = (base + 0.3 * rng.standard_normal(
                tree[name].shape)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in tree.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    x = rng.standard_normal((B, S + 4, spec.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, T, spec.d_model)).astype(np.float32)

    rout, rkv = ref_attention(rp, jnp.asarray(x[:, :S]), rspec, cross=True,
                              kv_x=jnp.asarray(enc), update_cache=True)
    n0 = FK.flash_attention.launches
    out, kv = attention(p, torch.from_numpy(x[:, :S]), spec, cross=True,
                        kv_x=torch.from_numpy(enc), update_cache=True)
    assert FK.flash_attention.launches == n0       # the plain version here
    close(out.numpy(), rout, 1e-5)
    close(kv.k.numpy(), rkv.k, 1e-5)
    close(kv.v.numpy(), rkv.v, 1e-5)
    assert kv.k.shape == (B, T, spec.n_kv, spec.head_dim)
    assert kv.pos == int(rkv.pos) == T
    # the queries attend to every key: a later query row does not change
    # an earlier one's output (no causal mask across)
    head, _ = attention(p, torch.from_numpy(x[:, :S // 2]), spec, cross=True,
                        kv_x=torch.from_numpy(enc))
    close(head.numpy(), out[:, :S // 2].numpy(), 1e-6)
    # decode: each step against the read-only cache
    cache = kv
    for t in range(S, S + 4):
        rstep, rkv2 = ref_attention(rp, jnp.asarray(x[:, t:t + 1]), rspec,
                                    cross=True, cache=rkv)
        step, cache = attention(p, torch.from_numpy(x[:, t:t + 1]), spec,
                                cross=True, cache=cache)
        close(step.numpy(), rstep, 1e-5)
        assert cache is kv and int(rkv2.pos) == T


@pytest.mark.parametrize("enc_len", [24, 56])
def test_encoder_stack_matches_reference(enc_len):
    """``_run_encoder``: the bidirectional stack over the frame embeddings
    and its final norm, on the reference's parameters."""
    rcfg, cfg = configs("seamless-m4t-large-v2")
    rparams = ref_init(rcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(np_tree(rparams))
    enc = frontend_inputs(cfg, enc_len, seed=enc_len)["enc_inputs"]
    want = ref_run_encoder(rparams, rcfg, jnp.asarray(enc),
                           RefBlockIO(cfg=rcfg, mode="prefill", rope={},
                                      rolling={}))
    got = _run_encoder(params, cfg, torch.from_numpy(enc),
                       BlockIO(cfg=cfg, mode="prefill", rope={}))
    assert got.shape == (B, enc_len, cfg.d_model)
    close(got.numpy(), want, 1e-4)
    # bidirectional: the last frame reaches the first frame's output
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    moved = _run_encoder(params, cfg, torch.from_numpy(enc2),
                         BlockIO(cfg=cfg, mode="prefill", rope={}))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_enc_dec_forward_needs_encoder_inputs():
    _, cfg = configs("seamless-m4t-large-v2")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder inputs"):
        forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))


# ------------------------------------------------------- the whole models
SERVE_CASES = [("seamless-m4t-large-v2", 24), ("seamless-m4t-large-v2", 56),
               ("internvl2-2b", 0)]
SERVE_IDS = ["seamless-enc24", "seamless-enc56", "internvl2"]


@pytest.fixture(scope="module", params=SERVE_CASES, ids=SERVE_IDS)
def served(request):
    """One reduced model in both packages from one set of parameters and
    one set of frontend inputs: the reference's prefill of S0 tokens + 8
    teacher-forced decode steps and greedy generation, and the port's."""
    arch, enc_len = request.param
    S = S0 + NEW
    rcfg, cfg = configs(arch)
    P = cfg.vlm_patches
    rparams = ref_init(rcfg, jax.random.PRNGKey(1))
    tree = np_tree(rparams)
    params = params_from_numpy(tree)
    tokens = np.random.default_rng(S0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    front = frontend_inputs(cfg, enc_len, seed=enc_len + 1)
    rkw = {k: jnp.asarray(v) for k, v in front.items()}
    kw = {k: torch.from_numpy(v) for k, v in front.items()}
    cache_len = S + P

    rlog, rcaches, rrolling = ref_prefill(rparams, rcfg,
                                          jnp.asarray(tokens[:, :S0]),
                                          cache_len=cache_len, **rkw)
    ref_steps = [np.asarray(rlog)]
    pos = jnp.asarray(S0 + P, jnp.int32)
    for t in range(S0, S):
        if t == S - 1:                 # the caches the last step reads
            ref_before_last = np_tree(rcaches)
        lg, rcaches = ref_decode(rparams, rcfg,
                                 jnp.asarray(tokens[:, t:t + 1]), rcaches,
                                 pos, rolling=rrolling)
        ref_steps.append(np.asarray(lg))
        pos = pos + 1
    ref_tokens = np.asarray(ref_greedy(rparams, rcfg,
                                       jnp.asarray(tokens[:, :S0]), n_new=NEW,
                                       cache_len=S0 + P + NEW, **rkw))

    tok = torch.from_numpy(tokens).long()
    n0 = FK.flash_attention.launches
    lg, caches, rolling = prefill(params, cfg, tok[:, :S0],
                                  cache_len=cache_len, **kw)
    steps = [lg.numpy()]
    for t in range(S0, S):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t + P,
                                 rolling=rolling)
        steps.append(lg.numpy())
    greedy = greedy_generate(params, cfg, tok[:, :S0], n_new=NEW, **kw)
    assert FK.flash_attention.launches == n0       # no kernel on the CPU
    return dict(arch=arch, enc_len=enc_len, P=P, S=S, rcfg=rcfg, cfg=cfg,
                tree=tree, params=params, tokens=tokens, front=front,
                ref_steps=ref_steps, ref_caches=np_tree(rcaches),
                ref_rolling=rrolling, ref_before_last=ref_before_last,
                ref_tokens=ref_tokens, steps=steps, caches=to_numpy(caches),
                rolling=rolling, greedy=greedy.numpy())


def test_rolling_map_matches_reference(served):
    cache_len = served["S"] + served["P"]
    assert served["rolling"] == served["ref_rolling"]
    assert served["rolling"] == ref_rolling_map(served["rcfg"], cache_len)
    assert rolling_map(served["cfg"], cache_len) == served["rolling"]
    kind = "dec" if served["cfg"].is_encdec else "attn"
    assert served["rolling"] == {kind: False}


def test_prefill_logits_match_reference(served):
    close(served["steps"][0], served["ref_steps"][0], 1e-4)


def test_teacher_forced_decode_matches_reference(served):
    scale = scale_of(served["ref_steps"][0])
    for t, (got, want) in enumerate(zip(served["steps"][1:],
                                        served["ref_steps"][1:])):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (t, err, scale)


def test_self_and_cross_caches_match_reference(served):
    """After decode: each ``dec`` layer's (self, cross) pair, the self
    cache at S (+ P) tokens, the cross cache as the encoder filled it."""
    cfg, S, P = served["cfg"], served["S"], served["P"]
    want = jax.tree.leaves(served["ref_caches"])
    got = jax.tree.leaves(served["caches"])
    per_layer = 6 if cfg.is_encdec else 3
    assert len(got) == len(want) == per_layer * cfg.n_layers
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.ndim:
            close(g, w, 1e-4)
        else:                                    # KVCache.pos
            assert int(g) == int(w)
    layer0 = served["caches"][0][0][0]
    if cfg.is_encdec:
        self_c, cross = layer0
        assert int(self_c.pos) == S and int(cross.pos) == served["enc_len"]
        assert self_c.k.shape[1] == S and cross.k.shape[1] == \
            served["enc_len"]
    else:
        assert int(layer0.pos) == S + P and layer0.k.shape[1] == S + P


def test_greedy_tokens_match_reference(served):
    assert served["greedy"].shape == (B, NEW)
    np.testing.assert_array_equal(served["greedy"], served["ref_tokens"])


def test_decode_matches_own_train_forward(served):
    """The port's prefill and decode against its own train forward over
    the whole sequence (the reference's tests/test_serve_decode.py:46-63);
    a VLM's logits sliced past its patches."""
    kw = {k: torch.from_numpy(v) for k, v in served["front"].items()}
    full = forward(served["params"], served["cfg"],
                   torch.from_numpy(served["tokens"]).long(),
                   **kw).logits.numpy()
    P = served["P"]
    assert full.shape[1] == served["S"] + P
    full = full[:, P:]
    scale = max(scale_of(full), 1.0)
    for t, got in zip(range(S0 - 1, served["S"]), served["steps"]):
        assert np.abs(got - full[:, t]).max() < 2e-3 * scale, t


def test_decode_from_reference_caches(served):
    """The reference's caches before the last teacher-forced step, carried
    into the port (``caches_from_numpy``: a ``dec`` layer's pair too), give
    the port's step the reference's logits; carried back (``to_numpy``)
    they are the same leaves."""
    cfg, S, P = served["cfg"], served["S"], served["P"]
    caches = caches_from_numpy(cfg, served["ref_before_last"])
    back = jax.tree.leaves(to_numpy(caches))
    want = jax.tree.leaves(served["ref_before_last"])
    assert len(back) == len(want)
    for g, w in zip(back, want):
        np.testing.assert_array_equal(g, w)
    tok = torch.from_numpy(served["tokens"][:, S - 1:]).long()
    got, _ = decode_step(served["params"], cfg, tok, caches, S - 1 + P,
                         rolling=served["rolling"])
    close(got.numpy(), served["ref_steps"][-1], 1e-4)


def test_convert_round_trips_every_leaf(served):
    """Every leaf of the reference's tree into the port and back, exactly:
    the stacked encoder and ``enc_ln_f``, the ``dec`` blocks' ``ln_x`` and
    ``xattn``."""
    back = params_to_numpy(served["params"])
    want, want_def = jax.tree.flatten(served["tree"])
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    cfg, params = served["cfg"], served["params"]
    layer0 = params["segments"][0][0][0]
    assert [[len(pos) for pos in seg] for seg in params["segments"]] == \
        [[cfg.n_layers]]
    if cfg.is_encdec:
        assert set(layer0) == {"ln1", "ln2", "attn", "ffn", "ln_x", "xattn"}
        assert len(params["encoder"]) == cfg.n_enc_layers
        assert set(params["encoder"][0]) == {"ln1", "ln2", "attn", "ffn"}
        np.testing.assert_array_equal(params["enc_ln_f"].numpy(),
                                      served["tree"]["enc_ln_f"])
    else:
        assert set(layer0) == {"ln1", "ln2", "attn", "ffn"}
        assert "encoder" not in params


def test_init_and_make_caches_match_reference(served):
    cfg, rcfg = served["cfg"], served["rcfg"]
    cache_len, enc_len = served["S"] + served["P"], served["enc_len"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, params_to_numpy(params))
    assert got == jax.tree.map(np.shape, served["tree"])
    want, rolling = ref_make_caches(rcfg, B, cache_len, enc_len=enc_len,
                                    stacked=False)
    got, rolling_p = make_caches(cfg, B, cache_len, enc_len=enc_len,
                                 device="cpu")
    assert rolling_p == rolling
    want = jax.tree.leaves(np_tree(want))
    got = jax.tree.leaves(to_numpy(got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.ndim:
            assert not np.any(g) and not np.any(w)
        else:                                    # cross caches: enc_len
            assert int(g) == int(w)


@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_enc_and_dec_blocks_initialise_with_reference_shapes(kind):
    from repro.models.model import init_block as ref_init_block
    rcfg, cfg = configs("seamless-m4t-large-v2")
    want = jax.tree.map(np.shape, ref_init_block(jax.random.PRNGKey(0),
                                                 rcfg, kind))
    got = jax.tree.map(np.shape, to_numpy(init_block(
        torch.Generator().manual_seed(0), cfg, kind)))
    assert got == want


def test_vlm_patches_shift_the_positions():
    """The patches take positions 0..P−1: the prefill's logits depend on
    them, and the train forward returns P + S rows."""
    _, cfg = configs("internvl2-2b")
    params = init_params(cfg, torch.Generator().manual_seed(5))
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, 12)))
    front = frontend_inputs(cfg, 0, seed=5)
    pe = torch.from_numpy(front["patch_embeds"])
    out = forward(params, cfg, tok, patch_embeds=pe).logits
    assert out.shape == (B, cfg.vlm_patches + 12, cfg.vocab_padded)
    other = forward(params, cfg, tok, patch_embeds=pe * 2).logits
    assert float((other[:, -1] - out[:, -1]).abs().max()) > 1e-4


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")])
def test_serve_cli_runs_on_cpu(arch, dtype):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "12", "--new-tokens", "4",
                    "--device", "cpu", "--dtype", dtype])
    text = out.getvalue()
    assert f"{arch}-reduced: prefill: 2×12 tokens" in text
    assert ("encoder 2×12 frames" in text) == arch.startswith("seamless")
    assert ("2×16 patches" in text) == arch.startswith("internvl2")
    assert f"torch.{dtype}" in text and "decode: 6 tokens" in text
    assert text.count("on cpu") == 2
