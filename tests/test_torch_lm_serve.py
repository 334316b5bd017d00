"""Port parity: zamba2-1.2b serving (prefill + decode) against the JAX
reference, on the CPU at the reduced size.

The reference's parameters (``repro.models.init_params``, f32) are carried
into the port with ``repro_torch.models.convert``, and the same numpy tokens
go through both packages. Tolerances, each with its reason:

* the Mamba-2 mixer and attention, one layer: 1e-5 of the output's scale —
  f32 both sides, the same formulas, sums in other orders (the port's SSD
  core is the plain ``ssd_scan``; its KV decode reads the same slots);
* the whole model: logits within 1e-4 of their scale (f32 rounding
  carried through 8 layers and 8 steps, with room to spare), caches within
  1e-4 of each leaf's scale, and the greedy tokens equal;
* the port's decode against its own train-mode forward: 2e-3 of the
  logits' scale, the reference's own pin (tests/test_serve_decode.py:54).
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
from repro.models.layers import KVCache as RefKV
from repro.models.layers import attention as ref_attention
from repro.models.layers import init_attention as ref_init_attention
from repro.models.layers import rope_tables as ref_rope
from repro.models.mamba import init_mamba2 as ref_init_mamba2
from repro.models.mamba import mamba2_forward as ref_m2_forward
from repro.models.mamba import mamba2_step as ref_m2_step
from repro.models.model import make_caches as ref_make_caches
from repro.models.model import shared_attn_spec as ref_shared_spec
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import greedy_generate as ref_greedy
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.models import forward, init_params
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        to_numpy)
from repro_torch.models.layers import AttnSpec, KVCache, attention, \
    rope_tables
from repro_torch.models.mamba import mamba2_forward, mamba2_step
from repro_torch.models.model import init_block, make_caches
from repro_torch.serve.serve_step import decode_step, greedy_generate, \
    prefill
from torch_threads import one_torch_thread  # noqa: F401

B, S0, S = 2, 40, 48          # prompt of 40 tokens, then 8 decode steps


def scale_of(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def close(got, want, rel):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale_of(want), (err, scale_of(want))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def zamba():
    """The reduced zamba2 in both packages from one set of parameters,
    tokens, the reference's prefill + teacher-forced decode, and the
    port's."""
    rcfg = dataclasses.replace(ref_config("zamba2-1.2b", reduced=True),
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              dtype=torch.float32)
    rparams = ref_init(rcfg, jax.random.PRNGKey(1))
    tree = np_tree(rparams)
    params = params_from_numpy(tree)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)

    rlog, rcaches, rolling = ref_prefill(rparams, rcfg,
                                         jnp.asarray(tokens[:, :S0]),
                                         cache_len=S)
    ref_steps = [np.asarray(rlog)]
    pos = jnp.asarray(S0, jnp.int32)
    for t in range(S0, S):
        lg, rcaches = ref_decode(rparams, rcfg, jnp.asarray(tokens[:, t:t + 1]),
                                 rcaches, pos, rolling=rolling)
        ref_steps.append(np.asarray(lg))
        pos = pos + 1

    tok = torch.from_numpy(tokens).long()
    lg, caches, rolling_p = prefill(params, cfg, tok[:, :S0], cache_len=S)
    steps = [lg.numpy()]
    for t in range(S0, S):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t,
                                 rolling=rolling_p)
        steps.append(lg.numpy())
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, tree=tree,
                params=params, tokens=tokens, ref_steps=ref_steps,
                ref_caches=np_tree(rcaches), steps=steps,
                caches=to_numpy(caches), rolling=rolling_p)


# ------------------------------------------------------------ (f) convert
def test_convert_round_trips_every_leaf(zamba):
    back = params_to_numpy(zamba["params"])
    want, want_def = jax.tree.flatten(zamba["tree"])
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_convert_unstacks_one_dict_per_layer(zamba):
    segs = zamba["params"]["segments"]
    assert [[len(pos) for pos in seg] for seg in segs] == [[2, 2, 2, 2]]
    w0 = segs[0][1][1]["mix"]["in_proj"].numpy()
    np.testing.assert_array_equal(
        w0, zamba["tree"]["segments"][0][1]["mix"]["in_proj"][1])


# ------------------------------------------------------- (c) Mamba-2 mixer
@pytest.fixture(scope="module")
def mixer():
    d, N, hp, chunk = 32, 16, 16, 16
    rp = ref_init_mamba2(jax.random.PRNGKey(3), d, d_state=N, headdim=hp)
    p = {k: torch.from_numpy(np.array(v)) for k, v in np_tree(rp).items()}
    x = np.random.default_rng(7).standard_normal((2, 37, d)).astype(
        np.float32)
    return dict(d=d, N=N, hp=hp, chunk=chunk, rp=rp, p=p, x=x)


def test_mamba2_forward_with_state_matches_reference(mixer):
    m = mixer
    kw = dict(d_state=m["N"], headdim=m["hp"], chunk=m["chunk"])
    ry, rs = ref_m2_forward(m["rp"], jnp.asarray(m["x"]), return_state=True,
                            **kw)
    y, s = mamba2_forward(m["p"], torch.from_numpy(m["x"]),
                          return_state=True, **kw)
    close(y.numpy(), ry, 1e-5)
    close(s.conv.numpy(), rs.conv, 1e-6)
    close(s.ssm.numpy(), rs.ssm, 1e-5)
    # continuing from a state: the second half of a split sequence
    a, b = m["x"][:, :20], m["x"][:, 20:]
    _, rs_a = ref_m2_forward(m["rp"], jnp.asarray(a), return_state=True, **kw)
    ry_b, _ = ref_m2_forward(m["rp"], jnp.asarray(b), state=rs_a, **kw)
    _, s_a = mamba2_forward(m["p"], torch.from_numpy(a), return_state=True,
                            **kw)
    y_b, _ = mamba2_forward(m["p"], torch.from_numpy(b), state=s_a, **kw)
    close(y_b.numpy(), ry_b, 1e-5)
    close(y_b.numpy(), y[:, 20:].numpy(), 1e-5)


def test_mamba2_step_matches_reference(mixer):
    m = mixer
    kw = dict(d_state=m["N"], headdim=m["hp"])
    _, rs = ref_m2_forward(m["rp"], jnp.asarray(m["x"][:, :30]),
                           return_state=True, chunk=m["chunk"], **kw)
    _, s = mamba2_forward(m["p"], torch.from_numpy(m["x"][:, :30]),
                          return_state=True, chunk=m["chunk"], **kw)
    for t in range(30, 37):
        xt = m["x"][:, t:t + 1]
        ry, rs = ref_m2_step(m["rp"], jnp.asarray(xt), rs, **kw)
        y, s = mamba2_step(m["p"], torch.from_numpy(xt), s, **kw)
        close(y.numpy(), ry, 1e-5)
    close(s.ssm.numpy(), rs.ssm, 1e-5)
    close(s.conv.numpy(), rs.conv, 1e-6)


# ------------------------------------------------------------ (d) attention
def test_attention_prefill_and_decode_match_reference():
    rcfg = ref_config("zamba2-1.2b", reduced=True)
    rspec = ref_shared_spec(rcfg)
    spec = AttnSpec(**dataclasses.asdict(rspec))
    rp = ref_init_attention(jax.random.PRNGKey(4), rspec)
    p = {k: torch.from_numpy(np.array(v)) for k, v in np_tree(rp).items()}
    x = np.random.default_rng(8).standard_normal((2, 24, spec.d_model))
    x = x.astype(np.float32)
    rc, rs = ref_rope(jnp.arange(20), spec.head_dim, spec.rope_base)
    c, s = rope_tables(torch.arange(20), spec.head_dim, spec.rope_base)
    close(c.numpy(), rc, 1e-6)
    close(s.numpy(), rs, 1e-6)
    # prefill over the first 20 tokens, building the cache
    rout, rkv = ref_attention(rp, jnp.asarray(x[:, :20]), rspec, cos=rc,
                              sin=rs, update_cache=True)
    out, kv = attention(p, torch.from_numpy(x[:, :20]), spec, cos=c, sin=s,
                        update_cache=True)
    close(out.numpy(), rout, 1e-5)
    close(kv.k.numpy(), rkv.k, 1e-5)
    close(kv.v.numpy(), rkv.v, 1e-5)
    assert kv.pos == int(rkv.pos) == 20
    # decode 4 tokens against a 24-slot cache
    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 4), (0, 0), (0, 0)))
    rcache = RefKV(jnp.asarray(pad(rkv.k)), jnp.asarray(pad(rkv.v)),
                   jnp.asarray(20, jnp.int32))
    cache = KVCache(torch.from_numpy(pad(kv.k)), torch.from_numpy(pad(kv.v)),
                    20)
    for t in range(20, 24):
        rc, rs = ref_rope(jnp.arange(t, t + 1), spec.head_dim,
                          spec.rope_base)
        c, s = rope_tables(torch.arange(t, t + 1), spec.head_dim,
                           spec.rope_base)
        rout, rcache = ref_attention(rp, jnp.asarray(x[:, t:t + 1]), rspec,
                                     cos=rc, sin=rs, cache=rcache)
        out, cache = attention(p, torch.from_numpy(x[:, t:t + 1]), spec,
                               cos=c, sin=s, cache=cache)
        close(out.numpy(), rout, 1e-5)
        assert cache.pos == int(rcache.pos) == t + 1
    close(cache.k.numpy(), rcache.k, 1e-5)


@pytest.mark.parametrize("kw,what", [
    (dict(cross=True), "cross"),
    (dict(kv_x=torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(
        0))), "kv_x")])
def test_attention_branches_of_later_slices_raise(kw, what):
    """The attention branches of ROADMAP queue 1 item 13c (enc-dec; the
    test's name dates from before they were ported), asked for by ``cross``
    or by a separate KV source ``kv_x``, run and match the reference's
    ``attention`` with the same arguments (the whole enc-dec path:
    tests/test_torch_lm_encdec.py). (Rolling caches, soft-capping and
    ``qk_norm``: tests/test_torch_lm_dense.py.)"""
    from repro.models.layers import AttnSpec as RefSpec
    dims = dict(d_model=8, n_heads=2, n_kv=2, head_dim=4)
    spec, rspec = AttnSpec(**dims), RefSpec(**dims)
    tree = np_tree(ref_init_attention(jax.random.PRNGKey(3), rspec))
    x = np.random.default_rng(3).standard_normal((1, 4, 8)).astype(
        np.float32)
    rc, rs = ref_rope(jnp.arange(4), 4, spec.rope_base)
    c, s = rope_tables(torch.arange(4), 4, spec.rope_base)
    rkw = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
           for k, v in kw.items()}
    want, rkv = ref_attention({k: jnp.asarray(v) for k, v in tree.items()},
                              jnp.asarray(x), rspec, cos=rc, sin=rs,
                              update_cache=True, **rkw)
    got, kv = attention({k: torch.tensor(v) for k, v in tree.items()},
                        torch.from_numpy(x), spec, cos=c, sin=s,
                        update_cache=True, **kw)
    close(got.numpy(), want, 1e-5)
    close(kv.k.numpy(), rkv.k, 1e-5)
    assert kv.pos == int(rkv.pos) == 4


# --------------------------------------------------- (e) the whole model
def test_prefill_last_logits_match_reference(zamba):
    close(zamba["steps"][0], zamba["ref_steps"][0], 1e-4)


def test_teacher_forced_decode_matches_reference(zamba):
    scale = scale_of(zamba["ref_steps"][0])
    for t, (got, want) in enumerate(zip(zamba["steps"][1:],
                                        zamba["ref_steps"][1:])):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (t, err, scale)


def test_decode_caches_match_reference(zamba):
    want, want_def = jax.tree.flatten(zamba["ref_caches"])
    got, got_def = jax.tree.flatten(zamba["caches"])
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.ndim == 0:                          # KVCache.pos
            assert int(g) == int(w) == S
        else:
            close(g, w, 1e-4)


def test_greedy_tokens_match_reference(zamba):
    prompt = zamba["tokens"][:, :S0]
    want = ref_greedy(zamba["rparams"], zamba["rcfg"], jnp.asarray(prompt),
                      n_new=8)
    got = greedy_generate(zamba["params"], zamba["cfg"],
                          torch.from_numpy(prompt).long(), n_new=8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_own_train_forward(zamba):
    full = forward(zamba["params"], zamba["cfg"],
                   torch.from_numpy(zamba["tokens"]).long()).logits.numpy()
    scale = max(scale_of(full), 1.0)
    for t, got in zip(range(S0 - 1, S), zamba["steps"]):
        assert np.abs(got - full[:, t]).max() < 2e-3 * scale, t


def test_cpu_serve_path_launches_no_kernel(zamba):
    n_ssd, n_fa = SK.ssd_scan.launches, FK.flash_attention.launches
    prefill(zamba["params"], zamba["cfg"],
            torch.from_numpy(zamba["tokens"][:, :8]).long(), cache_len=9)
    assert (SK.ssd_scan.launches, FK.flash_attention.launches) == (n_ssd,
                                                                   n_fa)


# ------------------------------------------------ registry, init and CLI
def test_config_matches_reference():
    for reduced in (False, True):
        ref = dataclasses.asdict(ref_config("zamba2-1.2b", reduced=reduced))
        got = dataclasses.asdict(get_config("zamba2-1.2b", reduced=reduced))
        ref.pop("dtype"), got.pop("dtype")
        assert got == ref
    cfg = get_config("zamba2-1.2b")
    rcfg = ref_config("zamba2-1.2b")
    assert cfg.n_params() == rcfg.n_params()
    assert cfg.vocab_padded == rcfg.vocab_padded == 32000
    assert get_config("zamba2-1.2b-reduced").name == "zamba2-1.2b-reduced"


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2",
                                  "mixtral-8x7b-reduced"])
def test_other_architectures_raise_naming_the_roadmap(arch):
    """The architectures of ROADMAP queue 1 items 13c and 13d, which raised
    naming the ROADMAP until each was ported, resolve to the reference's
    configurations."""
    got, want = (dataclasses.asdict(f(arch)) for f in (get_config,
                                                        ref_config))
    got.pop("dtype"), want.pop("dtype")
    assert got == want


def test_init_params_shapes_match_reference(zamba):
    cfg = zamba["cfg"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, params_to_numpy(params))
    want = jax.tree.map(np.shape, zamba["tree"])
    assert got == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    assert n > 0
    with pytest.raises(ValueError, match="unknown block kind"):
        init_block(torch.Generator(), cfg, "nope")   # as the reference


def test_make_caches_match_reference_layout(zamba):
    want, rolling = ref_make_caches(zamba["rcfg"], B, S, stacked=False)
    got, rolling_p = make_caches(zamba["cfg"], B, S, device="cpu")
    assert rolling_p == rolling == {}
    want = jax.tree.leaves(np_tree(want))
    got = jax.tree.leaves(to_numpy(got))
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        assert g.shape == w.shape                # pos: a scalar 0 in both
        assert w.ndim == 0 or g.dtype == w.dtype
        assert not np.any(g) and not np.any(w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_caches(zamba["cfg"], B, S)       # the card by default


def test_serve_cli_runs_on_cpu_and_defaults_to_cuda():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "zamba2-1.2b", "--reduced", "--batch", "2",
                    "--prompt-len", "12", "--new-tokens", "4",
                    "--device", "cpu"])
    text = out.getvalue()
    assert "prefill: 2×12 tokens" in text and "decode: 6 tokens" in text
    assert text.count("on cpu") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--reduced", "--prompt-len", "4"])


def test_serve_cli_defaults_to_granite_8b():
    """Without --arch the port's serve CLI serves granite-8b, as the
    reference's (repro/launch/serve.py) does."""
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--reduced", "--batch", "2", "--prompt-len", "12",
                    "--new-tokens", "4", "--device", "cpu"])
    text = out.getvalue()
    assert "granite-8b-reduced: prefill: 2×12 tokens" in text
    assert "decode: 6 tokens" in text and text.count("on cpu") == 2
