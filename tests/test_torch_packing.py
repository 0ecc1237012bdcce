"""The port's packed inference (``core/packing.py``, ``pipeline/packed.py``,
``kernels/attention/costing.pack_attention_stats``) against the JAX
package.

Counts (row assembly, the FLOPs ledger, block-tile statistics) are host
arithmetic done term for term as in the reference: equal exactly. Packed
forwards and packed steps hold at float32 1e-5. The reference runs its
dense attention path (the plain reference of its Pallas kernel, which it
would otherwise run in interpret mode); the port runs ``attn_backend=
"auto"``, which on packed rows resolves to the flash kernel's wrapper, and
on CPU tensors to the kernel's plain version. The reference's DDPM noise
is drawn from its keys in JAX and handed to the port as tensors.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import packing as jpack
from repro.diffusion import schedule as jschedule
from repro.kernels.attention import costing as jcost
from repro.models import dit as jdit
from repro.pipeline import packed as jpacked
from repro_torch import convert
from repro_torch.core import packing as tpack
from repro_torch.diffusion import schedule as tschedule
from repro_torch.kernels.attention import costing as tcost
from repro_torch.models import dit as tdit
from repro_torch.pipeline import packed as tpacked

jflex = importlib.import_module("repro.core.flexify")

TOL = dict(atol=1e-5, rtol=1e-5)


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    """The reference's serving-test model: the tiny DiT flexified to patch
    (1, 4, 4): mode 0 has 64 tokens, mode 1 has 16. Returns reference
    params, the config, and the port's params."""
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])
    key = jax.random.PRNGKey(21)
    fp["ps_embed"] = jax.random.normal(key, fp["ps_embed"].shape) * 0.1
    return fp, fcfg, to_torch(fp)


@pytest.fixture(scope="module")
def xl_cfgs():
    """dit-xl-2 at full width (host arithmetic only: mode 0 has 256
    tokens, mode 1 has 64, so the flash kernel's 128-token tiles hold
    several segments) and cut to 2 layers and d=64."""
    from repro import configs as jcfgs
    cfg = jcfgs.get_config("dit-xl-2")
    return cfg, cfg.reduced()


# ---------------------------------------------------------------------------
# Counts: exact


ROW_PACKS = [([[64]], 64), ([[16, 16, 16, 16]], 64), ([[64], [16, 16, 16]], 64),
             ([[16] * 8, [16, 100]], 256), ([[256], [64, 64, 64, 64]], 256),
             ([[100, 28], [128]], 128), ([[5, 7, 9]], 300)]


@pytest.mark.parametrize("rows,cap", ROW_PACKS)
def test_pack_attention_stats_matches_reference(rows, cap):
    for bq, bk in [(128, 128), (64, 64), (48, 80)]:
        assert tcost.pack_attention_stats(rows, cap, block_q=bq, block_k=bk) \
            == jcost.pack_attention_stats(rows, cap, block_q=bq, block_k=bk)


SEG_LISTS = [[64, 16, 16, 16, 16, 64], [16] * 5, [64, 64], [16, 64, 16, 64, 16],
             [30, 20, 10, 50, 40], [256, 64, 64, 64, 64, 64, 256, 64]]


@pytest.mark.parametrize("segs", SEG_LISTS)
def test_assign_rows_matches_reference(segs):
    for cap in (max(segs), 2 * max(segs), 256):
        if cap < max(segs):
            continue
        assert tpack.assign_rows(segs, cap) == jpack.assign_rows(segs, cap)
    with pytest.raises(ValueError, match="capacity"):
        tpack.assign_rows(segs, max(segs) - 1)


MODE_LISTS = [[0], [1], [1, 1, 1, 1], [0, 1], [0, 1, 1, 1, 1], [1] * 5,
              [0, 0, 1, 1, 0, 1], [1] * 9]


@pytest.mark.parametrize("modes", MODE_LISTS)
def test_pack_costs_match_reference(flexi, xl_cfgs, modes):
    """pack_ratio, packed_row_flops, mixed_pack_cost and
    pack_attention_block_stats: equal exactly, all backends, three models."""
    _, fcfg, _ = flexi
    for cfg in (fcfg,) + xl_cfgs:
        assert tpack.pack_ratio(cfg, 1) == jpack.pack_ratio(cfg, 1)
        N0 = tdit.tokens_for_mode(cfg, 0)
        for backend in ("dense", "pallas", "auto"):
            want = jpack.mixed_pack_cost(cfg, modes, attn_backend=backend)
            got = tpack.mixed_pack_cost(cfg, modes, attn_backend=backend)
            assert (got.rows, got.flops, got.real_tokens, got.packed_tokens) \
                == (want.rows, want.flops, want.real_tokens, want.packed_tokens)
            assert got.efficiency == want.efficiency
            for cap in (N0, 2 * N0):
                w = jpack.mixed_pack_cost(cfg, modes, cap, attn_backend=backend)
                g = tpack.mixed_pack_cost(cfg, modes, cap, attn_backend=backend)
                assert (g.rows, g.flops) == (w.rows, w.flops)
            row = [m for m in modes][:tpack.pack_ratio(cfg, 1)]
            if sum(tdit.tokens_for_mode(cfg, m) for m in row) <= N0:
                assert tpack.packed_row_flops(cfg, row, N0, backend) \
                    == jpack.packed_row_flops(cfg, row, N0, backend)
        assert tpack.pack_attention_block_stats(cfg, modes) \
            == jpack.pack_attention_block_stats(cfg, modes)
    with pytest.raises(ValueError, match="exceed"):
        tpack.packed_row_flops(fcfg, [1] * 5, capacity=64)


@pytest.mark.parametrize("n_images", [1, 3, 4, 9])
def test_packing_cost_matches_reference(flexi, n_images):
    _, fcfg, _ = flexi
    got = tpack.packing_cost(fcfg, 1, n_images)
    want = jpack.packing_cost(fcfg, 1, n_images)
    assert [(c.approach, c.nfe_calls, c.flops, c.longest_row_tokens)
            for c in got] == [(c.approach, c.nfe_calls, c.flops,
                               c.longest_row_tokens) for c in want]


def test_split_blocks_slices_the_stack(flexi):
    fp, fcfg, tp = flexi
    for split in (0, 1, 2):
        js, jd = jdit.split_blocks(fp["blocks"], split)
        ts, td = tdit.split_blocks(tp["blocks"], split)
        for j, t in [(js, ts), (jd, td)]:
            tl = [x for _, x in sorted(_flat(t).items())]
            jl = [x for _, x in sorted(_flat(j).items())]
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert ts["ada"]["w"].shape[0] == split
        assert td["ada"]["w"].shape[0] == fcfg.num_layers - split


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# Packed forwards: 1e-5


def _pack_inputs(cfg, groups, seed):
    rng = np.random.default_rng(seed)
    xs, ts, cs = [], [], []
    for _m, n in groups:
        xs.append(rng.standard_normal((n,) + cfg.dit.latent_shape)
                  .astype(np.float32))
        ts.append(rng.integers(0, 100, n).astype(np.int32))
        cs.append(rng.integers(0, cfg.dit.num_classes + 1, n).astype(np.int32))
    return xs, ts, cs


GROUPS = [((0, 1), (1, 4)), ((0, 3), (1, 1)), ((1, 5),), ((0, 2),),
          ((0, 1), (1, 0))]


@pytest.mark.parametrize("groups", GROUPS)
def test_packed_mixed_forward_matches_reference(flexi, groups):
    fp, fcfg, tp = flexi
    xs, ts, cs = _pack_inputs(fcfg, groups, 3)
    want = jpack.packed_mixed_forward(
        fp, fcfg, groups, [jnp.asarray(x) for x in xs],
        [jnp.asarray(t) for t in ts], [jnp.asarray(c) for c in cs],
        attn_backend="dense")
    T = torch.from_numpy
    got = tpack.packed_mixed_forward(tp, fcfg, groups, [T(x) for x in xs],
                                     [T(t) for t in ts], [T(c) for c in cs])
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("flags", ["mixed", "none", "all"])
@pytest.mark.parametrize("groups", [((0, 2), (1, 3)), ((1, 4),)])
def test_packed_mixed_forward_cached_matches_reference(flexi, groups, flags):
    """Cached deltas: each segment's own refresh flag picks fresh vs
    replayed features; with no flag set the deep blocks do not run."""
    fp, fcfg, tp = flexi
    xs, ts, cs = _pack_inputs(fcfg, groups, 5)
    rng = np.random.default_rng(6)
    deltas, refresh = [], []
    for m, n in groups:
        N = tdit.tokens_for_mode(fcfg, m)
        deltas.append((rng.standard_normal((n, N, fcfg.d_model)) * 0.1)
                      .astype(np.float32))
        rf = {"mixed": np.arange(n) % 2 == 0, "none": np.zeros(n, bool),
              "all": np.ones(n, bool)}[flags]
        refresh.append(rf)
    J = jnp.asarray
    w_out, w_d = jpack.packed_mixed_forward(
        fp, fcfg, groups, [J(x) for x in xs], [J(t) for t in ts],
        [J(c) for c in cs], cache_deltas=[J(d) for d in deltas],
        cache_refresh=[J(r) for r in refresh], cache_split=1,
        attn_backend="dense")
    T = torch.from_numpy
    g_out, g_d = tpack.packed_mixed_forward(
        tp, fcfg, groups, [T(x) for x in xs], [T(t) for t in ts],
        [T(c) for c in cs], cache_deltas=[T(d) for d in deltas],
        cache_refresh=refresh, cache_split=1)
    for g, w in zip(g_out + g_d, list(w_out) + list(w_d)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cached_forward_decides_deep_blocks_on_host(flexi, monkeypatch):
    """The deep blocks run only when some segment refreshes, decided from
    the host flags; a device tensor of flags is refused."""
    _, fcfg, tp = flexi
    groups = ((0, 1), (1, 2))
    xs, ts, cs = _pack_inputs(fcfg, groups, 7)
    T = torch.from_numpy
    deltas = [torch.zeros(n, tdit.tokens_for_mode(fcfg, m), fcfg.d_model)
              for m, n in groups]
    calls = []
    real = tpack._packed_block
    monkeypatch.setattr(tpack, "_packed_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for flags, blocks in [([[False], [False, False]], 1),
                          ([[False], [True, False]], fcfg.num_layers)]:
        calls.clear()
        tpack.packed_mixed_forward(
            tp, fcfg, groups, [T(x) for x in xs], [T(t) for t in ts],
            [T(c) for c in cs], cache_deltas=deltas,
            cache_refresh=[np.asarray(f) for f in flags], cache_split=1)
        assert len(calls) == blocks
    meta = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="host"):
        tpack._host_flags(meta)


@pytest.mark.parametrize("r", [2, 4])
def test_packed_weak_forward_matches_reference(flexi, r):
    fp, fcfg, tp = flexi
    rng = np.random.default_rng(r)
    B = 3
    x = rng.standard_normal((r, B) + fcfg.dit.latent_shape).astype(np.float32)
    t = rng.integers(0, 100, B).astype(np.int32)
    c = rng.integers(0, 10, (r, B)).astype(np.int32)
    want = jpack.packed_weak_forward(fp, jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(c), fcfg, 1)
    got = tpack.packed_weak_forward(tp, torch.from_numpy(x),
                                    torch.from_numpy(t), torch.from_numpy(c),
                                    fcfg, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Packed steps: 1e-5


def _step_inputs(cfg, layout, k, seed):
    """Latents, metas [k, 3, n] (each request at its own step), reference
    keys [k, n, 2], and the noise the reference draws from them."""
    rng = np.random.default_rng(seed)
    xs, metas, keys, noise = [], [], [], []
    base = jax.random.PRNGKey(seed)
    for gi, (m, n) in enumerate(layout.groups):
        xs.append(rng.standard_normal((n,) + cfg.dit.latent_shape)
                  .astype(np.float32))
        meta = np.zeros((k, 3, n), np.int32)
        start = rng.integers(k + 1, 99, n)
        for j in range(k):
            meta[j, 0] = start - 10 * j
            meta[j, 1] = start - 10 * (j + 1)
        meta[k - 1, 1, 0] = -1                  # request 0's final x0 step
        meta[:, 2] = rng.integers(0, cfg.dit.num_classes, n)
        metas.append(meta)
        kk = jax.random.split(jax.random.fold_in(base, gi), k * n)
        keys.append(np.asarray(kk).reshape(k, n, 2))
        noise.append(np.stack([np.stack([
            np.asarray(jax.random.normal(kk[j * n + i], cfg.dit.latent_shape,
                                         jnp.float32))
            for i in range(n)]) for j in range(k)]))
    return xs, metas, keys, noise


STEP_CASES = [("ddim", 1, None), ("ddim", 3, None), ("ddpm", 1, None),
              ("ddpm", 3, None), ("ddim", 3, 1), ("ddpm", 3, 1),
              ("ddim", 1, 1)]


@pytest.mark.parametrize("solver,k,split", STEP_CASES)
def test_packed_step_matches_reference(flexi, solver, k, split):
    """Guided mixed-mode packed steps at k micro-steps, DDIM and DDPM
    (the reference's per-request noise handed over), plain and cached
    (per-request refresh flags that differ across micro-steps)."""
    fp, fcfg, tp = flexi
    layout = jpacked.PackLayout.for_counts({0: 1, 1: 2})
    tlayout = tpacked.PackLayout.for_counts({0: 1, 1: 2})
    js, ts_ = jschedule.linear_schedule(100), tschedule.linear_schedule(100)
    xs, metas, keys, noise = _step_inputs(fcfg, layout, k, 11 + k)
    kw = dict(solver=solver, guidance_scale=1.5, k_steps=k, cache_split=split)
    jstep = jax.jit(jpacked.make_packed_step_fn(fcfg, js, layout,
                                                attn_backend="dense", **kw))
    tstep = tpacked.make_packed_step_fn(fcfg, ts_, tlayout, **kw)
    J, T = jnp.asarray, torch.from_numpy
    args_j = ([J(x) for x in xs], [J(m) for m in metas], [J(kk) for kk in keys])
    args_t = ([T(x) for x in xs], [T(m) for m in metas], [T(z) for z in noise])
    if split is None:
        want = jstep(fp, *args_j)
        got = tstep(tp, *args_t)
    else:
        rng = np.random.default_rng(k)
        deltas = [(rng.standard_normal((n, 2, tdit.tokens_for_mode(fcfg, m),
                                        fcfg.d_model)) * 0.1).astype(np.float32)
                  for m, n in layout.groups]
        refresh = [rng.random((k, n)) < 0.5 for _m, n in layout.groups]
        refresh[0][0] = True
        w_x, w_d = jstep(fp, *args_j, [J(d) for d in deltas],
                         [J(r) for r in refresh])
        g_x, g_d = tstep(tp, *args_t, [T(d) for d in deltas], refresh)
        for g, w in zip(g_d, w_d):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        want, got = w_x, g_x
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_packed_layout_matches_reference(flexi):
    _, fcfg, _ = flexi
    for counts in [{0: 1}, {1: 3}, {0: 2, 1: 1}, {0: 1, 1: 4}]:
        for guided in (True, False):
            j = jpacked.PackLayout.for_counts(counts, guided=guided)
            t = tpacked.PackLayout.for_counts(counts, guided=guided)
            assert t.groups == j.groups and t.n_requests == j.n_requests
            assert t.segment_modes() == j.segment_modes()
            assert t.resolve_capacity(fcfg) == j.resolve_capacity(fcfg)
            assert t.attention_block_stats(fcfg) == j.attention_block_stats(fcfg)
            jc, tc = j.cost(fcfg, "pallas"), t.cost(fcfg, "pallas")
            assert (tc.rows, tc.flops, tc.packed_tokens) \
                == (jc.rows, jc.flops, jc.packed_tokens)


def test_packed_step_validation(flexi):
    _, fcfg, _ = flexi
    sched = tschedule.linear_schedule(100)
    layout = tpacked.PackLayout.for_counts({0: 1})
    # taps=True is ported (tests/test_torch_telemetry.py)
    with pytest.raises(ValueError, match="solvers"):
        tpacked.make_packed_step_fn(fcfg, sched, layout, solver="dpm2")
    with pytest.raises(ValueError, match="k_steps"):
        tpacked.make_packed_step_fn(fcfg, sched, layout, k_steps=0)
    with pytest.raises(ValueError, match="deep block"):
        tpacked.make_packed_step_fn(fcfg, sched, layout,
                                    cache_split=fcfg.num_layers)
    with pytest.raises(ValueError, match="guidance_scale=0"):
        tpacked.make_packed_step_fn(fcfg, sched, layout, guidance_scale=0.0)
    step = tpacked.make_packed_step_fn(fcfg, sched, layout, solver="ddpm")
    with pytest.raises(ValueError, match="noise"):
        step({}, [torch.zeros((1,) + fcfg.dit.latent_shape)],
             [torch.zeros(1, 3, 1, dtype=torch.int32)], None)
