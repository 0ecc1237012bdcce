"""The port's MoE, vision and audio language models against the JAX
package, on the CPU: the four configs, the MoE layer (router, capacity,
the sorted dispatch and the dense oracle, aux losses, drops, ties),
cross-attention and the gated cross block, whisper's encoder, prefill and
3 KV-cache decode steps for each family, the ``pallas`` prefill against
the reference's interpret-mode kernel, the cache padding, the weight
bridge, the CLI, and ``init_tree``'s in-place draws.

Every config is the arch's ``reduced()`` one (2 layers, d=64, float32; 4
experts, top-2). Parameters are the reference's ``lm.init_params`` draws,
every all-zero leaf (norm scales, biases, the cross block's gates) filled
with small numpy draws so those paths carry values, carried into the port
by ``convert.lm_params_from_numpy``. Inputs are numpy from a seed.
Tolerances: each module 1e-5 (both sides in float32, sums in other
orders), MoE outputs, aux losses and ``dropped_fraction`` too; prefill
logits and cache, and 3 decode steps after it, 1e-4.
"""
import dataclasses
import math

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
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import padding as jpad
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.runtime import padding as tpad

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
B, S, N_DECODE = 2, 40, 3
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "llama-3.2-vision-90b",
         "whisper-small"]
MOE_ARCHS = ARCHS[:2]


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


def layer(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def tlayer(tree, i):
    return tcommon.tree_map(lambda t: t[i], tree)


def hidden(d, b=B, s=S, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.fixture(scope="module")
def setups():
    """(reference cfg, port cfg, reference params, port params) per arch,
    built once in this module."""
    out = {}
    for arch in ARCHS:
        jcfg = jcfgs.get_config(arch).reduced()
        tcfg = tcfgs.get_config(arch).reduced()
        rng = np.random.default_rng(len(arch))
        jp = fill_zero_leaves(np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(3))), rng)
        tp = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
        out[arch] = (jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp)
    return out


def inputs_for(cfg, b=B, s=S, seed=0):
    """numpy prompt (and the vision / audio states) for one family."""
    rng = np.random.default_rng(seed)
    inp = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.family == "vlm":
        inp["vision"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)
                                            ).astype(np.float32)
    if cfg.family == "audio":
        inp["frames"] = rng.standard_normal((b, cfg.audio_frames, cfg.d_model)
                                            ).astype(np.float32)
    return inp


# ---------------------------------------------------------------------------
# Configs


@pytest.mark.parametrize("arch", ARCHS)
def test_family_configs_equal_field_for_field(arch):
    want, got = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.num_params() == want.num_params()
    assert got.reduced().num_params() == want.reduced().num_params()
    assert arch in tcfgs.LM_ARCHS
    np.testing.assert_array_equal(tlm.layer_windows(got), jlm.layer_windows(want))
    # the port's schema holds the reference's names and shapes
    js = jax.tree.map(lambda s: s.shape, jlm.lm_schema(want.reduced()),
                      is_leaf=lambda x: hasattr(x, "init"))
    ts = tcommon.tree_map(lambda s: s.shape, tlm.lm_schema(got.reduced()))
    assert ts == js


def test_deepseek_moe_16b_size():
    cfg = tcfgs.get_config("deepseek-moe-16b")
    n = tcommon.count_params(tcommon.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tlm.lm_schema(cfg)))
    assert 16.8e9 < n < 16.9e9           # 33.8 GB in bf16
    assert tlm.lm_schema(cfg)["blocks"]["moe"]["w_in"].shape == (28, 64, 2048, 1408)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches(arch):
    for overrides in ({}, {"capacity_factor": 0.5}, {"capacity_factor": 2.0}):
        jm = dataclasses.replace(jcfgs.get_config(arch).moe, **overrides)
        tm = dataclasses.replace(tcfgs.get_config(arch).moe, **overrides)
        for n in (1, 7, 8, 40, 100, 513, 2048, 4096, 32768):
            assert tmoe.capacity(n, tm) == jmoe.capacity(n, jm)
    assert tmoe.capacity(1, tcfgs.get_config("deepseek-moe-16b").moe) == 8
    assert tmoe.capacity(4096, tcfgs.get_config("deepseek-moe-16b").moe) == 480


# ---------------------------------------------------------------------------
# The MoE layer


def moe_case(setups, arch, **overrides):
    jcfg, tcfg, jp, tp = setups[arch]
    jm = dataclasses.replace(jcfg.moe, **overrides)
    tm = dataclasses.replace(tcfg.moe, **overrides)
    return jm, tm, layer(jp["blocks"], 0)["moe"], tlayer(tp["blocks"], 0)["moe"], jcfg


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0], ids=["drops", "no_drops"])
def test_moe_sorted_and_dense_match_reference(setups, arch, capacity_factor):
    jm, tm, pj, pt, jcfg = moe_case(setups, arch, capacity_factor=capacity_factor)
    x = hidden(jcfg.d_model)
    act = jcfg.mlp_activation
    for jfn, tfn in ((jmoe.moe_apply_sorted, tmoe.moe_apply_sorted),
                     (jmoe.moe_apply_dense, tmoe.moe_apply_dense)):
        want, waux = jfn(pj, jnp.asarray(x), jm, act)
        got, gaux = tfn(pt, to_t(x), tm, act)
        close(got, want)
        assert sorted(gaux) == sorted(waux)
        for k in waux:
            close(gaux[k], waux[k])
    dropped = float(tmoe.moe_apply_sorted(pt, to_t(x), tm, act)[1]["dropped_fraction"])
    if capacity_factor == 2.0:       # = E / k: every assignment has a slot
        assert dropped == 0.0
        close(tmoe.moe_apply_sorted(pt, to_t(x), tm, act)[0],
              tmoe.moe_apply_dense(pt, to_t(x), tm, act)[0].numpy())
    else:
        assert dropped > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_pick_the_reference_experts(setups, arch):
    """A zero router gives every expert the same probability: both pick
    the lowest indices (jax.lax.top_k's order), and route identically."""
    jm, tm, pj, pt, jcfg = moe_case(setups, arch)
    pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = hidden(jcfg.d_model).reshape(B * S, -1)
    gates_j, idx_j, _, _ = jmoe._router(pj, jnp.asarray(x), jm)
    gates_t, idx_t, _, _ = tmoe._router(pt, to_t(x), tm)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert (idx_t == torch.arange(tm.num_experts_per_tok)).all()
    close(gates_t, gates_j)
    # and a whole layer routed on those ties
    want, _ = jmoe.moe_apply_sorted(pj, jnp.asarray(x.reshape(B, S, -1)), jm,
                                    jcfg.mlp_activation)
    got, _ = tmoe.moe_apply_sorted(pt, to_t(x.reshape(B, S, -1)), tm,
                                   jcfg.mlp_activation)
    close(got, want)
    vals, idx = tmoe.top_k_lower_index_first(torch.tensor([[1.0, 3.0, 3.0, 1.0]]), 3)
    assert idx.tolist() == [[1, 2, 0]] and vals.tolist() == [[3.0, 3.0, 1.0]]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_prefill_matches(setups, arch):
    """One MoE block on the dense backend: output, cache and aux losses."""
    jcfg, tcfg, jp, tp = setups[arch]
    x = hidden(jcfg.d_model)
    want, wc, waux = jblocks.block_apply(layer(jp["blocks"], 0), jnp.asarray(x), jcfg,
                                         window=0, mode="prefill", backend="dense")
    got, gc, gaux = tblocks.block_apply(tlayer(tp["blocks"], 0), to_t(x), tcfg,
                                        window=0, mode="prefill", backend="dense")
    close(got, want)
    close_tree(gc, wc, MOD_TOL)
    assert sorted(gaux) == sorted(waux) == ["dropped_fraction", "load_balance",
                                            "router_z"]
    for k in waux:
        close(gaux[k], waux[k])


# ---------------------------------------------------------------------------
# Cross-attention, the cross block, the encoder


def test_cross_attention_and_cross_block_match(setups):
    jcfg, tcfg, jp, tp = setups["llama-3.2-vision-90b"]
    pj, pt = layer(jp["groups"]["cross"], 0), tlayer(tp["groups"]["cross"], 0)
    x = hidden(jcfg.d_model)
    kv = hidden(jcfg.d_model, s=jcfg.vision_tokens, seed=2)
    valid = np.ones((B, jcfg.vision_tokens), bool)
    valid[1, 5:] = False
    for kv_valid in (None, valid):
        jv = None if kv_valid is None else jnp.asarray(kv_valid)
        tv = None if kv_valid is None else torch.from_numpy(kv_valid)
        close(tattn.cross_attention(pt["xattn"], to_t(x), to_t(kv), tcfg.attn,
                                    kv_valid=tv),
              jattn.cross_attention(pj["xattn"], jnp.asarray(x), jnp.asarray(kv),
                                    jcfg.attn, kv_valid=jv))
        close(tblocks.cross_block_apply(pt, to_t(x), to_t(kv), tcfg, kv_valid=tv),
              jblocks.cross_block_apply(pj, jnp.asarray(x), jnp.asarray(kv), jcfg,
                                        kv_valid=jv))
    assert np.all(np.asarray(pj["gate_attn"]) != 0)     # filled, so the path shows


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_audio_encode_matches(setups, backend):
    """Whisper's encoder (non-causal): dense, and ``pallas`` against the
    reference's interpret-mode kernel."""
    jcfg, tcfg, jp, tp = setups["whisper-small"]
    frames = inputs_for(jcfg)["frames"]
    want = jlm._audio_encode(jp, jnp.asarray(frames), jcfg, backend)
    got = tlm._audio_encode(tp, to_t(frames), tcfg, backend)
    close(got, want)


# ---------------------------------------------------------------------------
# Prefill and decode, 1e-4


def run_reference(jcfg, jp, inp, n_decode, backend="xla"):
    """Reference prefill then greedy decode steps; returns (logits per
    step, caches per step, the tokens fed)."""
    logits, cache = jsteps.make_prefill_step(jcfg, backend=backend)(
        jp, jax.tree.map(jnp.asarray, inp))
    logits_all, caches, fed = [np.asarray(logits)], [np_tree(cache)], []
    s = inp["tokens"].shape[1]
    cache = jpad.pad_kv_cache(cache, s, n_decode)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    decode = jsteps.make_decode_step(jcfg)
    for i in range(n_decode):
        fed.append(tok)
        pos = jnp.full((tok.shape[0],), s + i, jnp.int32)
        logits, cache = decode(jp, cache, jnp.asarray(tok), pos)
        logits_all.append(np.asarray(logits))
        caches.append(np_tree(cache))
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    return logits_all, caches, fed


def t_inputs(inp):
    return {k: to_t(v) for k, v in inp.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(setups, arch):
    jcfg, tcfg, jp, tp = setups[arch]
    inp = inputs_for(jcfg)
    want_logits, want_caches, fed = run_reference(jcfg, jp, inp, N_DECODE)
    logits, cache = tsteps.make_prefill_step(tcfg)(tp, t_inputs(inp))
    close(logits, want_logits[0], E2E_TOL)
    close_tree(cache, want_caches[0])
    cache = tpad.pad_kv_cache(cache, S, N_DECODE)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(N_DECODE):      # the reference's greedy tokens, fed to both
        logits, cache = decode(tp, cache, to_t(fed[i]),
                               torch.full((B,), S + i, dtype=torch.int32))
        close(logits, want_logits[i + 1], E2E_TOL)
        close_tree(cache, want_caches[i + 1])


def reference_pallas_prefill(jcfg, jp, inp):
    """The reference's prefill on ``pallas`` (the Pallas kernel in
    interpret mode). Its ``lm.prefill`` refuses ``pallas`` for the
    dense/MoE body (its windows reach ``block_apply`` as array scalars,
    which count as traced: ROADMAP queue 3), so those layers are driven
    here with Python-int windows, as its ``prefill`` would; the vision
    and audio paths pass the int 0 and run as they are."""
    if jcfg.family in ("vlm", "audio"):
        logits, cache = jlm.prefill(jp, jnp.asarray(inp["tokens"]), jcfg,
                                    extra=jax.tree.map(jnp.asarray, inp),
                                    backend="pallas")
        return logits, np_tree(cache)
    x = jlm.embed_tokens(jp, jnp.asarray(inp["tokens"]), jcfg)
    cache = {}
    for i, w in enumerate(jlm.layer_windows(jcfg)):
        x, c, _ = jblocks.block_apply(layer(jp["blocks"], i), x, jcfg,
                                      window=int(w), mode="prefill",
                                      backend="pallas")
        for k in c:
            cache.setdefault(k, []).append(np.asarray(c[k]))
    return (jlm.unembed(jp, x[:, -1:], jcfg)[:, 0],
            {k: np.stack(v) for k, v in cache.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_prefill_matches_reference_kernel(setups, arch):
    """The port's ``pallas`` prefill (its plain flash on the CPU) against
    the reference's, then against the port's dense backend."""
    jcfg, tcfg, jp, tp = setups[arch]
    inp = inputs_for(jcfg, seed=7)
    want, wcache = reference_pallas_prefill(jcfg, jp, inp)
    got, cache = tsteps.make_prefill_step(tcfg, backend="pallas")(tp, t_inputs(inp))
    close(got, want, E2E_TOL)
    close_tree(cache, wcache)
    dense, _ = tsteps.make_prefill_step(tcfg, backend="dense")(tp, t_inputs(inp))
    close(got, dense.numpy(), E2E_TOL)


def test_prefill_reports_moe_aux(setups):
    """``aux_out`` holds the MoE aux losses summed over layers."""
    jcfg, tcfg, jp, tp = setups["deepseek-moe-16b"]
    inp = inputs_for(jcfg, seed=3)
    x = jlm.embed_tokens(jp, jnp.asarray(inp["tokens"]), jcfg)
    want = jlm._aux_zero(jcfg)
    for i in range(jcfg.num_layers):
        x, _, a = jblocks.block_apply(layer(jp["blocks"], i), x, jcfg, window=0,
                                      mode="prefill", backend="dense")
        want = jlm._aux_add(want, a)
    aux = {}
    tlm.prefill(tp, to_t(inp["tokens"]), tcfg, aux_out=aux)
    close_tree(aux, np_tree(want), MOD_TOL)
    assert tlm._aux_zero(tcfgs.get_config("whisper-small")) == {}


# ---------------------------------------------------------------------------
# Padding, the weight bridge, the CLI, the draws


def test_pad_kv_cache_on_vlm_and_audio_caches(setups):
    for arch in ("llama-3.2-vision-90b", "whisper-small"):
        jcfg, tcfg, _, _ = setups[arch]
        jc, tc = jlm.init_cache(jcfg, B, S), tlm.init_cache(tcfg, B, S, device="cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        got = tpad.pad_kv_cache(tc, S, 5)
        close_tree(got, np_tree(jpad.pad_kv_cache(jc, S, 5)))
        assert got["k"].shape[-3] == S + 5
        for k in ("xk", "xv", "enc"):
            if k in tc:
                assert got[k] is tc[k]


def test_reference_pads_the_vision_cache_when_the_prompt_is_as_long(setups):
    """The reference pads by shape, so a prompt as long as the image's
    token count (8 at the reduced config) also pads the vision keys and
    values with zero keys, which the cross layer then attends to (ROADMAP
    queue 3). The port pads by name: its decode equals the reference's
    from a cache whose ``xk`` / ``xv`` are left whole, and the
    reference's own padded decode reads otherwise."""
    jcfg, tcfg, jp, tp = setups["llama-3.2-vision-90b"]
    Tv = jcfg.vision_tokens
    inp = inputs_for(jcfg, s=Tv, seed=4)
    _, jcache = jsteps.make_prefill_step(jcfg)(jp, jax.tree.map(jnp.asarray, inp))
    padded = jpad.pad_kv_cache(jcache, Tv, 2)
    assert padded["xk"].shape[2] == Tv + 2                # the reference's fault
    whole = dict(padded, xk=jcache["xk"], xv=jcache["xv"])
    tok = inp["tokens"][:, :1]
    pos = jnp.full((B,), Tv, jnp.int32)
    want, _ = jsteps.make_decode_step(jcfg)(jp, whole, jnp.asarray(tok), pos)
    faulty, _ = jsteps.make_decode_step(jcfg)(jp, padded, jnp.asarray(tok), pos)
    _, cache = tsteps.make_prefill_step(tcfg)(tp, t_inputs(inp))
    cache = tpad.pad_kv_cache(cache, Tv, 2)
    assert cache["xk"].shape[2] == Tv
    got, _ = tsteps.make_decode_step(tcfg)(tp, cache, to_t(tok),
                                           torch.full((B,), Tv, dtype=torch.int32))
    close(got, want, E2E_TOL)
    assert np.abs(np.asarray(faulty) - np.asarray(want)).max() > 1e-3


def test_convert_refuses_a_wrong_groups_tree(setups):
    jcfg, tcfg, jp, _ = setups["llama-3.2-vision-90b"]
    tree = np_tree(jp)
    # the self layers flattened to [G*(k-1), ...] in place of [G, k-1, ...]
    tree["groups"]["self"] = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                          tree["groups"]["self"])
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    tree = np_tree(jp)
    tree["groups"]["cross"]["gate_x"] = tree["groups"]["cross"]["gate_attn"]
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    tree = np_tree(jp)
    tree["blocks"] = tree.pop("groups")
    with pytest.raises(ValueError):
        convert.lm_params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama-3.2-vision-90b",
                                  "whisper-small"])
def test_serve_lm_cli_smoke_on_cpu(capsys, arch):
    m = tserve.main(["--arch", arch, "--smoke", "--requests", "3",
                     "--batch-slots", "2", "--prompt-len", "8", "--max-new", "4",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert m["served"] == 3.0 and m["tokens"] == 9.0 and m["decode_steps"] == 6.0
    assert "served 3 requests, 9 tokens" in out
    assert out.count("[batch done]") == 2


def test_init_tree_draws_in_place_bit_for_bit():
    """The in-place draws equal the out-of-place formula bit for bit
    (``erfinv(2u - 1) * sqrt(2) * std``, then the cast), for every init
    kind and dtype."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))

    def old(spec, gen, dtype):
        if spec.init == "embed":
            return (torch.randn(spec.shape, generator=gen) * spec.scale).to(dtype)
        fan_in = math.prod(spec.shape[:-1]) if len(spec.shape) >= 2 else spec.shape[0]
        std = spec.scale if spec.scale != 0.02 else 1.0 / math.sqrt(max(1, fan_in))
        u = torch.empty(spec.shape, dtype=torch.float32)
        u.uniform_(lo, hi, generator=gen)
        return ((torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)) * std).to(dtype)

    def in_draw_order(tree):          # init_tree's walk: insertion order
        for v in tree.values():
            yield from (in_draw_order(v) if isinstance(v, dict) else (v,))

    schema = tlm.lm_schema(tcfgs.get_config("deepseek-moe-16b").reduced())
    for dtype in (torch.float32, torch.bfloat16):
        got = in_draw_order(tcommon.init_tree(
            schema, torch.Generator().manual_seed(5), dtype))
        gen = torch.Generator().manual_seed(5)
        for spec, t in zip(in_draw_order(schema), got):
            if spec.init in ("zeros", "ones"):
                continue
            assert torch.equal(t, old(spec, gen, dtype)), spec
