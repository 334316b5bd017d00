"""Port parity: the MoE serving path (block kind ``moe``: sliding-window
attention + top-2 capacity-buffer MoE; mixtral-8x7b, mixtral-8x22b) against
the JAX reference, on the CPU at the reduced sizes.

The reference's parameters (``repro.models.init_params`` and
``repro.models.moe.init_moe``, f32) are carried into the port with
``repro_torch.models.convert``, and the same numpy inputs go through both
packages. Tolerances, each with its reason:

* routing — the experts each token picks, in order, its slot in the
  expert's buffer, whether it is kept —, ``tokens_per_expert`` and
  ``dropped_fraction``: exactly. They are decisions and counts, not sums;
  ties go to the lower index in both (a stable descending sort in the
  port, ``lax.top_k`` in the reference), as a forced-tie case checks;
* one MoE layer's output: 1e-5 of its scale (f32 both sides, the same
  formulas, sums in other orders); ``aux_loss`` within 1e-6 of its value
  (a mean over the tokens, summed in another order);
* the whole model: logits and caches within 1e-4 of their scale,
  ``expert_counts`` exactly, ``aux_loss`` within 1e-6 of its value, greedy
  tokens equal (tests/test_torch_lm_dense.py's pins);
* the port's decode against its own train-mode forward: 2e-3 of the
  logits' scale, the reference's own pin (tests/test_serve_decode.py:54).

The reduced models' window is 64 tokens: the prompt of 80 reaches past it
in prefill, and decode to 88 tokens rolls the window-sized caches. The
kernel runs only on the card (tests/test_torch_lm_cuda.py).
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
from repro.models.model import forward as ref_forward
from repro.models.model import init_block as ref_init_block
from repro.models.model import make_caches as ref_make_caches
from repro.models.model import rolling_map as ref_rolling_map
from repro.models.moe import init_moe as ref_init_moe
from repro.models.moe import moe as ref_moe
from repro.serve.serve_step import decode_step as ref_decode
from repro.serve.serve_step import greedy_generate as ref_greedy
from repro.serve.serve_step import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import forward, init_params, make_caches, rolling_map
from repro_torch.models.convert import (caches_from_numpy, params_from_numpy,
                                        params_to_numpy, to_numpy)
from repro_torch.models.model import init_block
from repro_torch.models.moe import init_moe, moe, route
from repro_torch.serve.serve_step import (decode_step, greedy_generate,
                                          prefill)
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["mixtral-8x7b", "mixtral-8x22b"]
B, S0, NEW = 2, 80, 8          # batch, prompt (> the window 64), decode steps


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


def ref_route(p, x, *, top_k, capacity_factor, group_size):
    """The reference's routing, its own lines (``repro/models/moe.py:
    60-77``) on its own arrays: (gate_idx, pos, keep, gate_vals)."""
    B_, S, d = x.shape
    E = p["router"].shape[1]
    N = B_ * S
    g = min(group_size, N)
    while N % g:
        g //= 2
    G = N // g
    xt = x.reshape(G, g, d)
    logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(G, g * top_k, E)
    pos = jnp.cumsum(flat, axis=1) * flat
    pos = pos.reshape(G, g, top_k, E).sum(-1) - 1
    cap = max(int(np.ceil(top_k * g / E * capacity_factor)), top_k)
    return (np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < cap),
            np.asarray(gate_vals))


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
    assert get_config(arch).vocab_padded == ref_config(arch).vocab_padded


# ------------------------------------------------------------ one MoE layer
D, FF = 32, 48
MOE_CASES = {                  # (B, S, E, capacity factor, group size)
    "no-drops": (2, 40, 4, 8.0, 1024),
    "cf1.25": (2, 64, 8, 1.25, 1024),
    "cf0.3": (2, 64, 8, 0.3, 1024),
    "decode": (4, 1, 8, 1.25, 1024),           # N = B: g 4, cap 2
    "group-halves": (2, 60, 8, 1.25, 32),      # N 120: g 32 → 16 → 8
}


def moe_pair(E, seed, dtype=jnp.float32):
    """One MoE layer's reference parameters (jax) and the port's (torch),
    the same values."""
    rp = ref_init_moe(jax.random.PRNGKey(seed), D, FF, E, dtype=dtype)
    return rp, params_from_numpy({"ffn": np_tree(rp),
                                  "segments": []})["ffn"]


def check_moe(rp, p, x, *, capacity_factor, group_size):
    """The port's ``moe`` and ``route`` against the reference's ``moe`` and
    routing on one numpy input."""
    kw = dict(top_k=2, capacity_factor=capacity_factor, group_size=group_size)
    ry, rs = ref_moe(rp, jnp.asarray(x), **kw)
    y, s = moe(p, torch.from_numpy(x), **kw)
    close(y.numpy(), ry, 1e-5)
    np.testing.assert_array_equal(s.tokens_per_expert.numpy(),
                                  np.asarray(rs.tokens_per_expert))
    assert s.dropped_fraction.dtype == torch.float32
    assert float(s.dropped_fraction) == float(rs.dropped_fraction)
    assert abs(float(s.aux_loss) - float(rs.aux_loss)) <= \
        1e-6 * abs(float(rs.aux_loss))
    r = route(p, torch.from_numpy(x), **kw)
    idx, pos, keep, vals = ref_route(rp, jnp.asarray(x), **kw)
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    close(r.gate_vals.numpy(), vals, 1e-6)
    return r, float(rs.dropped_fraction)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    """Output, routing, slots, counts, drops and aux loss of one MoE layer
    at capacity factors with and without drops, at a decode-sized N and
    where the group size halves."""
    Bx, S, E, cf, gs = MOE_CASES[case]
    rp, p = moe_pair(E, seed=E)
    x = np.random.default_rng(S).standard_normal((Bx, S, D)).astype(
        np.float32)
    r, dropped = check_moe(rp, p, x, capacity_factor=cf, group_size=gs)
    if case == "no-drops":
        assert dropped == 0.0
    if case == "cf0.3":
        assert dropped > 0.5
    if case == "group-halves":
        assert r.gate_idx.shape[:2] == (15, 8)
    if case == "decode":
        assert r.cap == 2 and r.gate_idx.shape[:2] == (1, 4)


def test_forced_tie_goes_to_the_lower_index():
    """Experts 1 and 2 share a router column: every token ties them, and
    the lower index must come first, as ``lax.top_k`` orders ties
    (``torch.topk`` does not promise it). With expert 0's column raised,
    the tie sits at the 2nd/3rd place for many tokens, where the order
    decides which expert runs."""
    rp, p = moe_pair(8, seed=3)
    router = np.array(rp["router"])
    router[:, 2] = router[:, 1]
    router[:, 0] += 0.5
    rp = dict(rp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router.copy()))
    x = np.random.default_rng(7).standard_normal((2, 64, D)).astype(
        np.float32)
    for cf in (8.0, 1.25):
        r, _ = check_moe(rp, p, x, capacity_factor=cf, group_size=1024)
        idx = r.gate_idx.numpy()
        # 2 comes only after its tie 1, never before it or without it
        assert np.all(idx[..., 0] != 2)
        assert np.all(idx[idx[..., 1] == 2][:, 0] == 1)
        assert np.any(idx[..., 1] == 1)            # the tie in 2nd place


def test_bf16_routing_matches_reference_with_ties():
    """In bf16 the router's logits are bf16-rounded before the softmax:
    ties among them are common, and the port routes exactly as the
    reference (the layer's output is checked in tests/test_torch_lm_bf16.py
    through the whole model)."""
    rp, p = moe_pair(8, seed=5, dtype=jnp.bfloat16)
    x32 = np.random.default_rng(5).standard_normal((4, 128, D)).astype(
        np.float32)
    xj = jnp.asarray(x32, jnp.bfloat16)
    x = torch.from_numpy(np.asarray(xj).view(np.uint16).copy()).view(
        torch.bfloat16)
    kw = dict(top_k=2, capacity_factor=1.25, group_size=1024)
    r = route(p, x, **kw)
    idx, pos, keep, _ = ref_route(rp, xj, **kw)
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    probs = r.probs.numpy()
    top = np.sort(probs, -1)[..., ::-1]
    assert np.any(top[..., 1] == top[..., 2])      # ties at the 2nd place
    _, rs = ref_moe(rp, xj, **kw)
    _, s = moe(p, x, **kw)
    np.testing.assert_array_equal(s.tokens_per_expert.numpy(),
                                  np.asarray(rs.tokens_per_expert))
    assert float(s.dropped_fraction) == float(rs.dropped_fraction)


def test_moe_block_initialises_with_reference_shapes():
    rcfg, cfg = configs("mixtral-8x7b")
    want = jax.tree.map(np.shape, ref_init_block(jax.random.PRNGKey(0),
                                                 rcfg, "moe"))
    got = jax.tree.map(np.shape, to_numpy(init_block(
        torch.Generator().manual_seed(0), cfg, "moe")))
    assert got == want
    p = init_moe(torch.Generator().manual_seed(0), D, FF, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (D, 4), "wi": (4, D, FF), "wg": (4, D, FF),
        "wo": (4, FF, D)}


# ------------------------------------------------------- the whole models
@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced mixtral in both packages from one set of parameters:
    the reference's prefill of S0 tokens + NEW teacher-forced decode steps
    (caches rolling at the window) and greedy generation, and the port's;
    each package's train and prefill forward with its MoE stats."""
    arch = request.param
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
                                       jnp.asarray(tokens[:, :S0]), n_new=NEW,
                                       cache_len=S))
    ref_fwd = {mode: ref_forward(rparams, rcfg, jnp.asarray(tokens[:, :S0]),
                                 mode=mode) for mode in ("train", "prefill")}

    tok = torch.from_numpy(tokens).long()
    n0 = FK.flash_attention.launches
    lg, caches, rolling = prefill(params, cfg, tok[:, :S0], cache_len=S)
    steps = [lg.numpy()]
    for t in range(S0, S):
        lg, caches = decode_step(params, cfg, tok[:, t:t + 1], caches, t,
                                 rolling=rolling)
        steps.append(lg.numpy())
    greedy = greedy_generate(params, cfg, tok[:, :S0], n_new=NEW)
    fwd = {mode: forward(params, cfg, tok[:, :S0], mode=mode)
           for mode in ("train", "prefill")}
    assert FK.flash_attention.launches == n0       # no kernel on the CPU
    return dict(arch=arch, S=S, rcfg=rcfg, cfg=cfg, tree=tree,
                params=params, tokens=tokens, ref_steps=ref_steps,
                ref_caches=np_tree(rcaches), ref_rolling=rrolling,
                ref_before_last=ref_before_last, ref_tokens=ref_tokens,
                ref_fwd=ref_fwd, fwd=fwd, steps=steps,
                caches=to_numpy(caches), rolling=rolling,
                greedy=greedy.numpy())


def test_rolling_map_matches_reference(served):
    assert served["rolling"] == served["ref_rolling"] == {"moe": True}
    assert served["rolling"] == ref_rolling_map(served["rcfg"], served["S"])
    assert rolling_map(served["cfg"], served["S"]) == served["rolling"]
    assert rolling_map(served["cfg"], 64) == {"moe": False}


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_logits_and_moe_stats_match_reference(served, mode):
    """Logits, the layers' summed ``expert_counts`` (exactly) and
    ``aux_loss``; in prefill the KV caches too."""
    got, want = served["fwd"][mode], served["ref_fwd"][mode]
    close(got.logits.numpy(), want.logits, 1e-4)
    E = served["cfg"].n_experts
    assert got.expert_counts.shape == (E,)
    assert got.expert_counts.dtype == got.aux_loss.dtype == torch.float32
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    # every layer routes each of the B·S0 tokens to top_k experts
    assert float(got.expert_counts.sum()) == \
        served["cfg"].n_layers * B * S0 * served["cfg"].top_k
    assert abs(float(got.aux_loss) - float(want.aux_loss)) <= \
        1e-6 * abs(float(want.aux_loss))
    if mode == "prefill":          # the reference's stacked over layers
        layers = to_numpy(got.caches)[0][0]
        stacked = np_tree(want.caches)[0][0]
        assert len(layers) == served["cfg"].n_layers
        for r, kv in enumerate(layers):
            close(kv.k, stacked.k[r], 1e-4)
            close(kv.v, stacked.v[r], 1e-4)
            assert int(kv.pos) == int(stacked.pos[r]) == S0
    else:
        assert got.caches is None


def test_models_without_experts_return_zero_stats():
    _, cfg = configs("granite-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    res = forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))
    assert res.aux_loss.shape == () and float(res.aux_loss) == 0.0
    assert res.expert_counts.shape == (1,)
    assert float(res.expert_counts[0]) == 0.0


def test_prefill_logits_match_reference(served):
    close(served["steps"][0], served["ref_steps"][0], 1e-4)


def test_teacher_forced_decode_matches_reference(served):
    scale = scale_of(served["ref_steps"][0])
    for t, (got, want) in enumerate(zip(served["steps"][1:],
                                        served["ref_steps"][1:])):
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * scale, (t, err, scale)


def test_rolling_caches_match_reference(served):
    """After decode to S0 + NEW = 88 tokens: each layer's window-sized (64
    slot) cache, wrapped, as the reference's."""
    cfg = served["cfg"]
    want = jax.tree.leaves(served["ref_caches"])
    got = jax.tree.leaves(served["caches"])
    assert len(got) == len(want) == 3 * cfg.n_layers
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.ndim:
            close(g, w, 1e-4)
        else:                                    # KVCache.pos
            assert int(g) == int(w) == served["S"]
    layer0 = served["caches"][0][0][0]
    assert layer0.k.shape == (B, cfg.window, cfg.n_kv, cfg.head_dim)


def test_greedy_tokens_match_reference(served):
    assert served["greedy"].shape == (B, NEW)
    np.testing.assert_array_equal(served["greedy"], served["ref_tokens"])


def test_decode_matches_own_train_forward(served):
    """The port's prefill and decode against its own train forward over
    the whole sequence (the reference's tests/test_serve_decode.py:46-63):
    the rolling caches hold what the window sees."""
    full = forward(served["params"], served["cfg"],
                   torch.from_numpy(served["tokens"]).long()).logits.numpy()
    scale = max(scale_of(full), 1.0)
    for t, got in zip(range(S0 - 1, served["S"]), served["steps"]):
        assert np.abs(got - full[:, t]).max() < 2e-3 * scale, t


def test_decode_from_reference_caches(served):
    """The reference's rolling caches before the last teacher-forced step,
    carried into the port (``caches_from_numpy``: the ``moe`` kind's KV
    cache), give the port's step the reference's logits; carried back
    (``to_numpy``) they are the same leaves."""
    cfg, S = served["cfg"], served["S"]
    caches = caches_from_numpy(cfg, served["ref_before_last"])
    back = jax.tree.leaves(to_numpy(caches))
    want = jax.tree.leaves(served["ref_before_last"])
    assert len(back) == len(want)
    for g, w in zip(back, want):
        np.testing.assert_array_equal(g, w)
    tok = torch.from_numpy(served["tokens"][:, S - 1:]).long()
    got, _ = decode_step(served["params"], cfg, tok, caches, S - 1,
                         rolling=served["rolling"])
    close(got.numpy(), served["ref_steps"][-1], 1e-4)


def test_convert_round_trips_every_leaf(served):
    """Every leaf of the reference's tree into the port and back, exactly:
    each layer's ``router`` and stacked experts ``wi``, ``wg``, ``wo``."""
    back = params_to_numpy(served["params"])
    want, want_def = jax.tree.flatten(served["tree"])
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    cfg = served["cfg"]
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    ffn = served["params"]["segments"][0][0][0]["ffn"]
    assert {k: tuple(v.shape) for k, v in ffn.items()} == {
        "router": (d, E), "wi": (E, d, ff), "wg": (E, d, ff),
        "wo": (E, ff, d)}


def test_init_and_make_caches_match_reference(served):
    cfg, rcfg, S = served["cfg"], served["rcfg"], served["S"]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    got = jax.tree.map(np.shape, params_to_numpy(params))
    assert got == jax.tree.map(np.shape, served["tree"])
    for cache_len in (S, 40):                  # rolling and full
        want, rolling = ref_make_caches(rcfg, B, cache_len, stacked=False)
        got, rolling_p = make_caches(cfg, B, cache_len, device="cpu")
        assert rolling_p == rolling == {"moe": cache_len > cfg.window}
        want = jax.tree.leaves(np_tree(want))
        got = jax.tree.leaves(to_numpy(got))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert not np.any(g) and not np.any(w)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("arch,dtype", [
    (a, d) for a in ARCHS for d in ("float32", "bfloat16")])
def test_serve_cli_runs_on_cpu(arch, dtype):
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "70", "--new-tokens", "4",
                    "--device", "cpu", "--dtype", dtype])
    text = out.getvalue()
    assert f"{arch}-reduced: prefill: 2×70 tokens" in text
    assert f"torch.{dtype}" in text and "decode: 6 tokens" in text
    assert text.count("on cpu") == 2
