"""The port's language-model serving path against the JAX package, on the
CPU: configs, the LM modules (norm, RoPE, MLP, attention, decode
attention, block), prefill and KV-cache decode for the dense, hybrid and
SSM configs, the int8 cache, the blocked attention path, the ``pallas``
backend at head width 256, padding, the steps and the CLI, and the bf16
``_linear`` that rounds once.

Every config is the arch's ``reduced()`` one (2 layers, d=64, float32).
Parameters are the reference's ``lm.init_params`` draws, with every
all-zero leaf (norm scales, biases, the SSM's A_log / dt_bias / conv_b)
filled with small numpy draws so those paths carry values, carried into
the port by ``convert.lm_params_from_numpy``. Inputs are numpy from a
seed. Tolerances: each module 1e-5 (both sides in float32, sums in other
orders); prefill logits and cache, and 3 decode steps after it, 1e-4
(two layers and the unembedding compound those differences). Where the
port's ``pallas`` backend runs its plain flash on the CPU, the reference
runs its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import dit as jdit
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.runtime import padding as jpad
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import dit as tdit
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.runtime import padding as tpad

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, N_DECODE = 2, 40, 3         # S past the reduced window (32)
# the dense, hybrid and SSM configs (the MoE, vision and audio ones are
# held in tests/test_torch_lm_families.py)
ARCHS = ["deepseek-7b", "qwen2.5-14b", "gemma2-9b", "gemma3-4b", "hymba-1.5b",
         "mamba2-130m"]
ATTN_ARCHS = [a for a in ARCHS if tcfgs.get_config(a).attn is not None]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_t(a, dtype=None):
    return convert.leaf_to_torch(np.asarray(a), device="cpu", dtype=dtype)


def close(got, want, tol=MOD_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def close_tree(got, want, tol=E2E_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], tol)


def fill_zero_leaves(tree, rng):
    """Every all-zero leaf gets small draws, so no path multiplies by 0."""
    def one(x):
        x = np.asarray(x)
        if not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


_CACHE = {}


def setup(arch, **overrides):
    """(reference cfg, port cfg, reference params, port params), built
    once per (arch, overrides) in this module."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _CACHE:
        jcfg = jcfgs.get_config(arch).reduced(**overrides)
        tcfg = tcfgs.get_config(arch).reduced(**overrides)
        rng = np.random.default_rng(len(arch))
        jp = fill_zero_leaves(np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(3))), rng)
        tp = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
        _CACHE[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp)
    return _CACHE[key]


def tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def hidden(cfg, b=B, s=S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def layer(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# Configs


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_configs_equal_field_for_field(arch):
    want, got = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.num_params() == want.num_params()
    np.testing.assert_array_equal(tlm.layer_windows(got), jlm.layer_windows(want))
    if got.attn is not None:
        assert [got.attn.window_for_layer(i) for i in range(got.num_layers)] \
            == [want.attn.window_for_layer(i) for i in range(want.num_layers)]


def test_gemma2_9b_shape_and_size():
    cfg = tcfgs.get_config("gemma2-9b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == \
        (42, 3584, 14336, 256000)
    assert (cfg.attn.num_heads, cfg.attn.num_kv_heads, cfg.head_dim) == (16, 8, 256)
    assert list(tlm.layer_windows(cfg)[:4]) == [4096, 0, 4096, 0]
    # every leaf of the schema counted: ~9.24 B parameters, 18.5 GB in bf16
    n = tcommon.count_params(tcommon.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tlm.lm_schema(cfg)))
    assert 9.2e9 < n < 9.3e9


def test_convert_refuses_a_tree_of_another_schema():
    jcfg, tcfg, jp, _ = setup("deepseek-7b")
    tree = np_tree(jp)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :, :1]
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    tree = np_tree(jp)
    tree["lm_head2"] = tree["embed"]
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, tcfg, device="cpu")


def test_later_families_raise_naming_the_slice():
    """Every family serves and trains, and ``sequence_parallel`` (once a
    raise naming the distributed slice) runs: with no mesh its forward
    and train step equal the plain ones bit for bit. The seams still open
    keep their raises, each naming its owner."""
    import argparse
    jcfg, tcfg, jp, tp = setup("deepseek-7b")
    cfg = dataclasses.replace(tcfg, sequence_parallel=True)
    toks = torch.from_numpy(np.arange(2 * S, dtype=np.int32).reshape(2, S)
                            % tcfg.vocab_size)
    assert torch.equal(tlm.forward_train(tp, toks, cfg)[0],
                       tlm.forward_train(tp, toks, tcfg)[0])
    with pytest.raises(NotImplementedError, match="later distributed slice"):
        tserve.serve_lm(tcfg, argparse.Namespace(mesh="1x2", replicas=1))
    with pytest.raises(NotImplementedError, match="not part of the port"):
        tserve.serve_lm(tcfg, argparse.Namespace(mesh=None, replicas=2))
    with pytest.raises(NotImplementedError, match="later distributed slice"):
        tserve.serve_dit(tcfgs.get_config("dit-xl-2"),
                         argparse.Namespace(mesh="1x2", replicas=2))


# ---------------------------------------------------------------------------
# Modules, each at 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_rope_mlp_match(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    x = hidden(jcfg)
    lp_j, lp_t = layer(jp["blocks"], 0), tcommon.tree_map(lambda t: t[0], tp["blocks"])
    close(tcommon.apply_norm(lp_t["ln1"], to_t(x), tcfg.norm_type),
          jcommon.apply_norm(lp_j["ln1"], jnp.asarray(x), jcfg.norm_type))
    close(tcommon.softcap(to_t(x) * 40, 30.0), jcommon.softcap(jnp.asarray(x) * 40, 30.0))
    if jcfg.attn is not None:
        a = jcfg.attn
        q = np.random.default_rng(2).standard_normal(
            (B, S, a.num_heads, a.head_dim)).astype(np.float32)
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1)) + 5
        close(tcommon.apply_rope(to_t(q), to_t(pos), a.rope_theta),
              jcommon.apply_rope(jnp.asarray(q), jnp.asarray(pos), a.rope_theta))
    if jcfg.d_ff:
        close(tmlp.mlp_apply(lp_t["mlp"], to_t(x), tcfg.mlp_activation),
              jmlp.mlp_apply(lp_j["mlp"], jnp.asarray(x), jcfg.mlp_activation))
    for act in ("swiglu", "geglu", "gelu"):
        g, u = hidden(jcfg, seed=5), hidden(jcfg, seed=6)
        close(tcommon.mlp_act(to_t(g), to_t(u), act),
              jcommon.mlp_act(jnp.asarray(g), jnp.asarray(u), act))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_and_bias_match(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    x = hidden(jcfg)
    pj = layer(jp["blocks"], 0)["attn"]
    pt = tcommon.tree_map(lambda t: t[0], tp["blocks"])["attn"]
    seg = np.zeros((B, S), np.int32)
    seg[0, 25:] = 1
    seg[1, 30:] = -1
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    for causal, window, segs in ((True, 0, None), (True, 16, None),
                                 (False, 0, seg), (True, 8, seg)):
        jseg = None if segs is None else jnp.asarray(segs)
        tseg = None if segs is None else to_t(segs)
        close(tattn.make_attention_bias(to_t(pos), to_t(pos), causal=causal,
                                        window=window, q_segment=tseg,
                                        k_segment=tseg),
              jattn.make_attention_bias(jnp.asarray(pos), jnp.asarray(pos),
                                        causal=causal, window=window,
                                        q_segment=jseg, k_segment=jseg))
        got = tattn.attention(pt, to_t(x), tcfg.attn, causal=causal,
                              window=window, segment_ids=tseg, backend="dense")
        want = jattn.attention(pj, jnp.asarray(x), jcfg.attn, causal=causal,
                               window=window, segment_ids=jseg, backend="dense")
        close(got, want)
    q, k, v = (np.asarray(t) for t in jattn.project_qkv(pj, jnp.asarray(x),
                                                        jnp.asarray(x), jcfg.attn))
    for got, want in zip(tattn.project_qkv(pt, to_t(x), to_t(x), tcfg.attn), (q, k, v)):
        close(got, want)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_attention_matches(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    a = jcfg.attn
    rng = np.random.default_rng(4)
    Sc = 48
    ck = rng.standard_normal((B, Sc, a.num_kv_heads, a.head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    x = hidden(jcfg, s=1, seed=9)
    pos = np.array([37, 44], np.int32)
    pj = layer(jp["blocks"], 0)["attn"]
    pt = tcommon.tree_map(lambda t: t[0], tp["blocks"])["attn"]
    for window in (0, 8):
        want, wc = jattn.decode_attention(pj, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                          jnp.asarray(x), jnp.asarray(pos), jcfg.attn,
                                          window=window)
        cache = {"k": to_t(ck), "v": to_t(cv)}
        got, gc = tattn.decode_attention(pt, cache, to_t(x), to_t(pos), tcfg.attn,
                                         window=window)
        close(got, want)
        close_tree(gc, wc, MOD_TOL)
        assert gc["k"] is cache["k"]        # written in place


@pytest.mark.parametrize("arch", ARCHS)
def test_block_prefill_matches(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    x = hidden(jcfg)
    w = int(jlm.layer_windows(jcfg)[0])
    want, wc, _ = jblocks.block_apply(layer(jp["blocks"], 0), jnp.asarray(x), jcfg,
                                      window=w, mode="prefill", backend="dense")
    got, gc, _ = tblocks.block_apply(tcommon.tree_map(lambda t: t[0], tp["blocks"]),
                                     to_t(x), tcfg, window=w, mode="prefill",
                                     backend="dense")
    close(got, want)
    close_tree(gc, wc, MOD_TOL)


# ---------------------------------------------------------------------------
# Prefill and decode, 1e-4


def run_reference(jcfg, jp, toks, n_decode, backend="xla", cache=None, start=None):
    """Reference prefill (unless a cache is given) then greedy decode steps;
    returns (logits per step, caches per step, the tokens fed)."""
    logits_all, caches, fed = [], [], []
    if cache is None:
        logits, cache = jsteps.make_prefill_step(jcfg, backend=backend)(
            jp, {"tokens": jnp.asarray(toks)})
        logits_all.append(np.asarray(logits))
        caches.append(np_tree(cache))
        cache = jpad.pad_kv_cache(cache, toks.shape[1], n_decode)
        start = toks.shape[1]
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    else:
        tok = toks[:, :1]
    decode = jsteps.make_decode_step(jcfg)
    for i in range(n_decode):
        fed.append(tok)
        pos = jnp.full((toks.shape[0],), start + i, jnp.int32)
        logits, cache = decode(jp, cache, jnp.asarray(tok), pos)
        logits_all.append(np.asarray(logits))
        caches.append(np_tree(cache))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    return logits_all, caches, fed


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    toks = tokens(jcfg)
    want_logits, want_caches, fed = run_reference(jcfg, jp, toks, N_DECODE)
    logits, cache = tsteps.make_prefill_step(tcfg)(tp, {"tokens": to_t(toks)})
    close(logits, want_logits[0], E2E_TOL)
    close_tree(cache, want_caches[0])
    cache = tpad.pad_kv_cache(cache, S, N_DECODE)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(N_DECODE):      # the reference's greedy tokens, fed to both
        logits, cache = decode(tp, cache, to_t(fed[i]),
                               torch.full((B,), S + i, dtype=torch.int32))
        close(logits, want_logits[i + 1], E2E_TOL)
        close_tree(cache, want_caches[i + 1])


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_int8_cache_decode_matches(arch):
    """Decode from an empty int8 cache (per position and head absmax):
    quantize on write, dequantize on read; logits 1e-4, the int8 entries
    equal, their scales 1e-4."""
    jcfg, tcfg, jp, tp = setup(arch, kv_cache_dtype="int8")
    toks = tokens(jcfg, s=N_DECODE + 1)
    jcache = jlm.init_cache(jcfg, B, 8)
    want_logits, want_caches, _ = run_reference(jcfg, jp, toks, N_DECODE,
                                                cache=jcache, start=0)
    cache = tlm.init_cache(tcfg, B, 8, device="cpu")
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.bfloat16
    tok = to_t(toks[:, :1])
    for i in range(N_DECODE):
        logits, cache = tlm.decode_step(tp, cache, tok,
                                        torch.full((B,), i, dtype=torch.int32), tcfg)
        close(logits, want_logits[i], E2E_TOL)
        for k in ("k", "v"):
            np.testing.assert_array_equal(cache[k].numpy(), want_caches[i][k])
        for k in ("k_scale", "v_scale"):
            close(cache[k], want_caches[i][k], E2E_TOL)
        tok = logits.argmax(-1).to(torch.int32)[:, None]


def test_pallas_prefill_at_head_width_256():
    """gemma2's reduced config widened to hd 256 (window 32, softcap 50 on
    S=40): the port's ``pallas`` prefill (its plain flash on the CPU)
    against the reference's blocks on ``pallas`` (the Pallas kernel in
    interpret mode), then against the port's own dense backend.

    The reference's ``lm.prefill`` cannot take ``pallas``: its windows
    reach ``block_apply`` as array scalars, which ``resolve_backend``
    counts as traced (ROADMAP queue 3), so its layers are driven here
    with Python-int windows, as its ``prefill`` would."""
    attn = dataclasses.replace(jcfgs.get_config("gemma2-9b").reduced().attn,
                               head_dim=256)
    jcfg, tcfg, jp, tp = setup("gemma2-9b", attn=attn)
    toks = tokens(jcfg, s=S)
    x = jlm.embed_tokens(jp, jnp.asarray(toks), jcfg)
    wcache = {}
    for i, w in enumerate(jlm.layer_windows(jcfg)):
        x, c, _ = jblocks.block_apply(layer(jp["blocks"], i), x, jcfg,
                                      window=int(w), mode="prefill",
                                      backend="pallas")
        for k in c:
            wcache.setdefault(k, []).append(np.asarray(c[k]))
    wcache = {k: np.stack(v) for k, v in wcache.items()}
    want = jlm.unembed(jp, x[:, -1:], jcfg)[:, 0]
    got, cache = tsteps.make_prefill_step(tcfg, backend="pallas")(
        tp, {"tokens": to_t(toks)})
    close(got, want, E2E_TOL)
    close_tree(cache, np_tree(wcache))
    dense, _ = tsteps.make_prefill_step(tcfg, backend="dense")(tp, {"tokens": to_t(toks)})
    close(got, dense.numpy(), E2E_TOL)


BLOCKED_CASES = [
    # causal, window, segmented, S
    (True, 12, False, 40),      # the sliced-K route (window < S)
    (True, 0, False, 40),
    (False, 0, True, 40),
    (True, 0, True, 37),        # a padded last block
    (False, 8, False, 33),
]


@pytest.mark.parametrize("case", BLOCKED_CASES, ids=[f"b{i}" for i in range(len(BLOCKED_CASES))])
def test_blocked_gqa_attend_matches(case):
    causal, window, segmented, s = case
    a = tcfgs.get_config("gemma2-9b").reduced().attn
    ja = jcfgs.get_config("gemma2-9b").reduced().attn
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((B, s, a.num_heads, a.head_dim)).astype(np.float32)
    k, v = (rng.standard_normal((B, s, a.num_kv_heads, a.head_dim)).astype(np.float32)
            for _ in range(2))
    pos = np.tile(np.arange(s, dtype=np.int32), (B, 1))
    seg = None
    if segmented:
        seg = np.zeros((B, s), np.int32)
        seg[0, 20:] = 1
        seg[1, s - 5:] = -1
    want = jattn.blocked_gqa_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), positions=jnp.asarray(pos),
        causal=causal, window=window, cfg=ja, q_block=16, unroll=True,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tattn.blocked_gqa_attend(
        to_t(q), to_t(k), to_t(v), positions=to_t(pos), causal=causal,
        window=window, cfg=a, q_block=16,
        segment_ids=None if seg is None else to_t(seg))
    close(got, want)


def test_dit_blocked_backend_matches_reference():
    """The DiT's self-attention on the blocked path (the seam closed with
    ``blocked_gqa_attend``) against the reference's, with segment ids."""
    cfg_j = jcfgs.get_config("dit-xl-2").reduced()
    rng = np.random.default_rng(8)
    d = cfg_j.d_model
    p = {k: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    pj = jax.tree.map(jnp.asarray, p)
    pt = convert.params_from_numpy(p, device="cpu")
    x = hidden(cfg_j, s=64)
    seg = np.zeros((B, 64), np.int32)
    seg[:, 40:] = 1
    heads = cfg_j.attn.num_heads
    want = jdit._mha(pj, jnp.asarray(x), heads, segment_ids=jnp.asarray(seg),
                     attn_backend="xla-blocked", unroll=True)
    got = tdit._mha(pt, to_t(x), heads, segment_ids=to_t(seg),
                    attn_backend="xla-blocked")
    close(got, want)


# ---------------------------------------------------------------------------
# Padding, the CLI


def test_padding_helpers_match_reference():
    for n, m in ((0, 1), (7, 8), (8, 8), (9, 8), (130, 64)):
        assert tpad.round_up_to_multiple(n, m) == jpad.round_up_to_multiple(n, m)
    with pytest.raises(ValueError):
        tpad.round_up_to_multiple(3, 0)
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    close(tpad.pad_to(to_t(x), 5, axis=1, value=-1.0),
          jpad.pad_to(jnp.asarray(x), 5, axis=1, value=-1.0))
    with pytest.raises(ValueError):
        tpad.pad_to(to_t(x), 2, axis=1)
    jcfg, tcfg, jp, tp = setup("hymba-1.5b")
    jc, tc = jlm.init_cache(jcfg, B, S), tlm.init_cache(tcfg, B, S, device="cpu")
    want = np_tree(jpad.pad_kv_cache(jc, S, 5))
    got = tpad.pad_kv_cache(tc, S, 5)
    close_tree(got, want)
    # an SSM state whose head count equals the prompt length stays as it is
    # (the reference's shape rule would pad it: ROADMAP queue 3)
    H = tc["h"].shape[2]
    got = tpad.pad_kv_cache(tlm.init_cache(tcfg, B, H, device="cpu"), H, 5)
    assert got["h"].shape == tc["h"].shape and got["k"].shape[2] == H + 5


@pytest.mark.parametrize("arch", ["gemma2-9b", "hymba-1.5b", "mamba2-130m"])
def test_serve_lm_cli_smoke_on_cpu(capsys, arch):
    m = tserve.main(["--arch", arch, "--smoke", "--requests", "3",
                     "--batch-slots", "2", "--prompt-len", "8", "--max-new", "4",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert m["served"] == 3.0 and m["tokens"] == 9.0 and m["decode_steps"] == 6.0
    assert "served 3 requests, 9 tokens" in out
    assert out.count("[batch done]") == 2


# ---------------------------------------------------------------------------
# Repair 1: one rounding


def test_bf16_linear_rounds_once_like_the_reference():
    """x @ w + b in bf16: float32 product and sum, one rounding. Element
    (0, 0) is planted where rounding the product first gives another bf16
    value: x.w = 1 + 2^-9 (bf16 rounds it to 1), b = 2^-8; one rounding
    gives 1 + 2^-7, two give 1 (a tie, to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x[0] = 0.0
    x[0, :2] = (1.0, 2.0 ** -9)
    w[:2, 0] = 1.0
    b[0] = 2.0 ** -8
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    xt, wt, bt = (to_t(a, torch.bfloat16) for a in (x, w, b))
    want = np.asarray(jdit._linear(xj, wj, bj), np.float32)
    got = tdit._linear(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want[0, 0] == 1.0 + 2.0 ** -7
    twice = (torch.matmul(xt.float(), wt.float()).to(torch.bfloat16).float()
             + bt.float()).to(torch.bfloat16)
    assert float(twice[0, 0]) == 1.0 != float(got[0, 0])
    # the LoRA branch (mode 1): the inner product in bf16, the rest in f32
    lora = {"a": rng.standard_normal((1, 16, 4)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((1, 4, 8)).astype(np.float32) * 0.1}
    want = np.asarray(jdit._linear(xj, wj, bj, lora=jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), lora), mode=1), np.float32)
    got = tdit._linear(xt, wt, bt, lora={k: to_t(v, torch.bfloat16)
                                         for k, v in lora.items()}, mode=1)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_matmul_f32_keeps_gradients():
    """The CPU route of ``matmul_f32`` (upcast) is differentiable, and its
    float32 result is the float32 product."""
    rng = np.random.default_rng(1)
    x = to_t(rng.standard_normal((3, 5)).astype(np.float32)).requires_grad_()
    w = to_t(rng.standard_normal((5, 2)).astype(np.float32)).requires_grad_()
    b = to_t(rng.standard_normal(2).astype(np.float32)).requires_grad_()
    y = tcommon.matmul_f32(x, w, b)
    close(y, x.detach().numpy() @ w.detach().numpy() + b.detach().numpy())
    y.sum().backward()
    close(x.grad, np.ones((3, 2), np.float32) @ w.detach().numpy().T)
    close(b.grad, np.full(2, 3.0, np.float32))
