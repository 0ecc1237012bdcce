"""The paper's text-to-video DiT (``video-dit``: 3D latents, temporal and
spatial weak modes, text cross-attention, LoRA) in the port against the
JAX package.

At ``video-dit.reduced()`` (2 layers, d=64, latent (4, 16, 16, 4): 256,
128 and 64 tokens at modes 0, 1 and 2, text 8 x 3072, LoRA rank 64) with
every all-zero leaf of the reference's init filled from a numpy seed, so
no path hides behind a zero gate: the forward on every attention backend,
the 3D flexify, and ``FlexiPipeline.sample`` over both weak modes, both
LoRA variants and both guidance kinds. At the full config (latent
(32, 88, 48, 8): 33,792 / 16,896 / 8,448 tokens) the host arithmetic:
3D patch helpers, token counts, the backend the sequence lengths resolve
to, and the plans the card runs.

Tolerances: float32 1e-5 per forward (both sides compute in float32, the
sums in another order); 1e-4 end to end, where six DDIM steps compound
that rounding. Host arithmetic (integers, numpy, the FLOPs ledger) equal
exactly.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.core import patch as jpatch
from repro.core import scheduler as jsched
from repro.diffusion import schedule as jschedule
from repro.models import attention as jattn
from repro.models import dit as jdit
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.core import patch as tpatch
from repro_torch.core import scheduler as tsched
from repro_torch.diffusion import schedule as tschedule
from repro_torch.models import attention as tattn
from repro_torch.models import dit as tdit
from repro_torch.pipeline import FlexiPipeline, SamplingPlan

# repro.core and repro_torch.core re-export the function flexify under
# the module's name
jflex = importlib.import_module("repro.core.flexify")
tflex = importlib.import_module("repro_torch.core.flexify")

TOL = dict(atol=1e-5, rtol=1e-5)
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
FULL = "video-dit"
FULL_TOKENS = (33792, 16896, 8448)
# chip_smoke.py phase 19's two plans at the full config: temporal weak
# mode at budget 0.6 over 4 steps, spatial at 0.25 over 8 (the paper's
# "75 % less compute")
CARD_PLANS = [(dict(T=4, budget=0.6, weak_mode=1), ((1, 3), (0, 1)), 0.511),
              (dict(T=8, budget=0.25, weak_mode=2), ((2, 7), (0, 1)), 0.244)]


def to_torch(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def fill_zero_leaves(tree, seed: int):
    """Every all-zero leaf (biases, de-embeddings, adaLN, cross-attention
    ``wo``, LoRA ``b``, per-mode embedding and LN) replaced by small normal
    draws from a numpy seed."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = [jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.05)
           if not np.any(np.asarray(a)) else a for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module")
def video():
    """Reference parameters of ``video-dit.reduced()`` with every all-zero
    leaf filled, the config, and the same parameters in the port."""
    cfg = jcfgs.get_config(FULL).reduced()
    jp = fill_zero_leaves(jdit.init_dit(cfg, jax.random.PRNGKey(31)), seed=31)
    assert all(np.any(np.asarray(a)) for a in jax.tree.leaves(jp))
    return jp, cfg, to_torch(jp)


def _inputs(cfg, seed: int = 0):
    """x_T [2, 4, 16, 16, 4], two timesteps, text [2, 8, 3072], a text mask
    that leaves out the first row's last three tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2,) + cfg.dit.latent_shape).astype(np.float32)
    t = np.array([3, 71], np.int32)
    text = rng.standard_normal((2, cfg.dit.text_len,
                                cfg.dit.text_dim)).astype(np.float32)
    mask = np.ones((2, cfg.dit.text_len), bool)
    mask[0, 5:] = False
    return x, t, text, mask


# ---------------------------------------------------------------------------
# The forward at every mode and attention backend


BACKENDS = ("dense", "pallas", "xla-blocked", "auto")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_video_forward_matches_reference(video, monkeypatch, mode, backend):
    """``dit_forward`` at each mode: dense, the flash kernel's plain
    version (the reference's kernel in interpret mode), the blocked path
    in query blocks of 96 (several blocks and a padded tail, as at the
    full length's 1024), and ``auto`` with the long-sequence threshold
    under these lengths in both packages, where it resolves to the kernel
    as 33,792 / 16,896 / 8,448 tokens do at the full config."""
    jp, cfg, tp = video
    if backend == "xla-blocked":
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "blocked_gqa_attend", functools.partial(
                mod.blocked_gqa_attend, q_block=96))
    if backend == "auto":
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 32)
        n = tdit.tokens_for_mode(cfg, mode)
        assert tattn.resolve_backend("auto", n_tokens=n, segmented=False) == \
            jattn.resolve_backend("auto", n_tokens=n, segmented=False) == "pallas"
    x, t, text, mask = _inputs(cfg)
    want = jdit.dit_forward(jp, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(text), cfg, mode=mode,
                            text_mask=jnp.asarray(mask), attn_backend=backend)
    got = tdit.dit_forward(tp, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(text), cfg, mode=mode,
                           text_mask=torch.from_numpy(mask),
                           attn_backend=backend)
    assert got.shape == (2,) + cfg.dit.latent_shape
    assert float(np.abs(np.asarray(want)).max()) > 1e-2     # not all zeros
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_video_text_mask_and_weak_modes_are_seen(video):
    """The checks above could not tell a dropped text mask or a weak mode
    run at the base patch: each changes the output."""
    _, cfg, tp = video
    x, t, text, mask = (torch.from_numpy(a) for a in _inputs(cfg))
    out = {m: tdit.dit_forward(tp, x, t, text, cfg, mode=m, text_mask=mask,
                               attn_backend="dense") for m in (0, 1, 2)}
    unmasked = tdit.dit_forward(tp, x, t, text, cfg, mode=0,
                                attn_backend="dense")
    assert (unmasked[0] - out[0][0]).abs().max() > 1e-3
    torch.testing.assert_close(unmasked[1], out[0][1], atol=0, rtol=0)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert (out[a] - out[b]).abs().max() > 1e-3


@pytest.mark.parametrize("S", [200, 192])
def test_blocked_attention_without_positions_equals_masked(S):
    """The DiT's blocked attention passes no positions (every row a real
    token): its unbiased scores give what the masked path gives, bit for
    bit, with a padded last query block (S 200) and without (S 192)."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    cfg = tcfgs.base.AttnConfig(num_heads=4, num_kv_heads=4, head_dim=16,
                                use_rope=False)
    pos = torch.arange(S, dtype=torch.int32).expand(2, S)
    kw = dict(causal=False, window=0, cfg=cfg, q_block=96)
    got = tattn.blocked_gqa_attend(q, k, v, positions=None, **kw)
    want = tattn.blocked_gqa_attend(q, k, v, positions=pos, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# 3D flexify (the reference's test_video_temporal_flexify)


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_video_temporal_flexify(tiny_dit_cfg, lora_rank):
    """A class-conditioned DiT at latent (4, 16, 16, 4) flexified to the
    temporal patch (2, 2, 2) and the spatial (1, 4, 4): the port's mode 0
    equals its unflexified forward, and modes 1 and 2 agree with the
    reference's flexified forward (the shared recipe lifts the embeddings
    to the underlying patch (2, 4, 4) by PI-resize; the LoRA recipe adds
    per-mode embeddings, its adapters' ``a`` drawn by each package and
    multiplied by ``b`` = 0)."""
    cfg = dataclasses.replace(tiny_dit_cfg, dit=dataclasses.replace(
        tiny_dit_cfg.dit, latent_shape=(4, 16, 16, 4)))
    jp = jdit.init_dit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    jp["deembed"]["w_flex"] = jnp.asarray(rng.standard_normal(
        jp["deembed"]["w_flex"].shape).astype(np.float32) * 0.1)
    x = rng.standard_normal((2,) + cfg.dit.latent_shape).astype(np.float32)
    t, y = np.array([10.0, 500.0], np.float32), np.array([1, 3], np.int32)
    sizes = [(2, 2, 2), (1, 4, 4)]
    jf, jfc = jflex.flexify(jp, cfg, sizes, lora_rank=lora_rank)
    tf, tfc = tflex.flexify(to_torch(jp), cfg, sizes, lora_rank=lora_rank)
    assert tfc == jfc

    def fwd(p, c, mode):
        return tdit.dit_forward(p, torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(y), c, mode=mode)

    base = fwd(to_torch(jp), cfg, 0)
    np.testing.assert_allclose(fwd(tf, tfc, 0).numpy(), base.numpy(), **TOL)
    for mode in (1, 2):
        want = jdit.dit_forward(jf, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(y), jfc, mode=mode)
        got = fwd(tf, tfc, mode)
        assert got.shape == base.shape and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# FlexiPipeline.sample


@pytest.fixture(scope="module")
def pipes(video):
    """One pipeline a package for the module (the port's keeps its merged
    LoRA trees and runners across the cases)."""
    jp, cfg, tp = video
    return (JPipeline(jp, cfg, jschedule.linear_schedule(100)),
            FlexiPipeline(tp, cfg, tschedule.linear_schedule(100), device="cpu"))


@pytest.mark.parametrize("kind", ["uncond", "weak_cond"])
@pytest.mark.parametrize("lora", ["merged", "unmerged"])
@pytest.mark.parametrize("weak_mode", [1, 2])
def test_video_sample_matches_reference(video, pipes, weak_mode, lora, kind):
    """DDIM, T=6, the first budget of 0.85, 0.7 and 0.6 that leaves weak
    steps first (weak-mode guidance and unmerged LoRA price the weak steps
    higher), CFG 1.5 with the text condition and the null text joined in
    one forward, each with its own mask: the port's x0 against the
    reference pipeline's."""
    _, cfg, _ = video
    jpipe, tpipe = pipes
    x, _, text, mask = _inputs(cfg, seed=1)
    null_mask = np.zeros_like(mask)
    null_mask[:, :2] = True
    for budget in (0.85, 0.7, 0.6):
        plan_kw = dict(T=6, budget=budget, weak_mode=weak_mode, lora=lora,
                       guidance_kind=kind)
        plan = SamplingPlan(**plan_kw)
        phases = plan.resolve_schedule(cfg).phases
        if phases[0][1] > 0:
            break
    assert phases[0][0] == weak_mode and phases[0][1] > 0
    want = jpipe.sample(JPlan(**plan_kw), 2, jax.random.PRNGKey(3),
                        cond=jnp.asarray(text), x_T=jnp.asarray(x),
                        text_mask=jnp.asarray(mask),
                        null_text_mask=jnp.asarray(null_mask))
    got = tpipe.sample(plan, 2, None, cond=torch.from_numpy(text),
                       x_T=torch.from_numpy(x),
                       text_mask=torch.from_numpy(mask),
                       null_text_mask=torch.from_numpy(null_mask))
    assert got.relative_compute == want.relative_compute
    assert float(np.abs(np.asarray(want.x0)).max()) > 1.0
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0), **E2E_TOL)


# ---------------------------------------------------------------------------
# The full config: host arithmetic


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_video_patch_helpers_at_full_latent(mode):
    """Latent (32, 88, 48, 8) at patch (1, 2, 2), (2, 2, 2) and (1, 4, 4):
    token counts, patch centres, patchify and unpatchify equal to the
    reference's exactly, and the sin-cos table at d 3072 on every 7th
    centre and the last (the table is computed row by row; the whole one
    at mode 0 is 415 MB in float32 a package)."""
    cfg = tcfgs.get_config(FULL)
    ls = cfg.dit.latent_shape
    p = tdit.patch_sizes(cfg)[mode]
    assert jdit.patch_sizes(jcfgs.get_config(FULL))[mode] == p
    n = tpatch.num_tokens(ls, p)
    assert n == jpatch.num_tokens(ls, p) == FULL_TOKENS[mode]
    assert tdit.tokens_for_mode(cfg, mode) == \
        jdit.tokens_for_mode(jcfgs.get_config(FULL), mode) == n
    coords = tpatch.patch_centers(ls, p)
    np.testing.assert_array_equal(coords, jpatch.patch_centers(ls, p))
    rows = np.r_[0:n:7, n - 1]
    np.testing.assert_array_equal(
        tpatch.sincos_pos_embed(cfg.d_model, coords[rows]),
        jpatch.sincos_pos_embed(cfg.d_model, coords[rows]))
    x = np.random.default_rng(mode).standard_normal((1,) + ls).astype(np.float32)
    tok = tpatch.patchify(torch.from_numpy(x), p)
    assert tok.shape == (1, n, int(np.prod(p)), ls[-1])
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jpatch.patchify(jnp.asarray(x), p)))
    np.testing.assert_array_equal(tpatch.unpatchify(tok, ls, p).numpy(), x)


def test_video_lengths_resolve_to_the_kernel():
    """33,792, 16,896 and 8,448 tokens are all past the long-sequence
    threshold: ``auto`` picks the flash kernel at every mode, in both
    packages, and so does the unsegmented check the forward makes."""
    assert tattn.BLOCKED_ATTN_THRESHOLD == jattn.BLOCKED_ATTN_THRESHOLD == 8192
    for n in FULL_TOKENS:
        for seg in (False, True):
            assert tattn.resolve_backend("auto", n_tokens=n, segmented=seg) \
                == jattn.resolve_backend("auto", n_tokens=n, segmented=seg) \
                == "pallas"


@pytest.mark.parametrize("lora", ["merged", "unmerged"])
@pytest.mark.parametrize("weak_mode", [1, 2])
@pytest.mark.parametrize("budget", [0.25, 0.6, 1.0])
@pytest.mark.parametrize("T", [4, 6, 8])
def test_video_plans_price_like_reference(T, budget, weak_mode, lora):
    """Phases, relative compute and FLOPs of plans of 4, 6 and 8 steps at
    the full config equal to the reference's exactly; the per-row NFE
    FLOPs and the LoRA overhead of each mode too."""
    jc, tc = jcfgs.get_config(FULL), tcfgs.get_config(FULL)
    kw = dict(T=T, budget=budget, weak_mode=weak_mode, lora=lora)
    want, got = JPlan(**kw), SamplingPlan(**kw)
    if budget == 0.25 and weak_mode == 1:
        # the temporal patch halves the tokens: no weak-first plan costs a
        # quarter, and both packages refuse it alike
        for plan, cfg in ((want, jc), (got, tc)):
            with pytest.raises(ValueError, match="no weak-first schedule"):
                plan.resolve_schedule(cfg)
        return
    assert got.resolve_schedule(tc).phases == want.resolve_schedule(jc).phases
    assert got.relative_compute(tc) == want.relative_compute(jc)
    assert got.flops(tc, batch=1) == want.flops(jc, batch=1)
    assert got.relative_compute(tc) <= budget + 1e-12
    for mode in (0, weak_mode):
        assert tsched.dit_nfe_flops(tc, mode) == jsched.dit_nfe_flops(jc, mode)
        assert tsched.lora_nfe_overhead(tc, mode) == \
            jsched.lora_nfe_overhead(jc, mode)


@pytest.mark.parametrize("case", CARD_PLANS, ids=["temporal", "spatial"])
def test_video_card_plans(case):
    """chip_smoke.py phase 19's plans: the phases it runs, the relative
    compute it prints, and the TFLOP a row-NFE it prices achieved TFLOP/s
    with (738.5 / 257.1 / 100.7 at modes 0 / 1 / 2)."""
    kw, phases, rel = case
    tc = tcfgs.get_config(FULL)
    plan = SamplingPlan(**kw)
    assert plan.resolve_schedule(tc).phases == phases
    assert round(plan.relative_compute(tc), 3) == rel
    assert [round(tsched.dit_nfe_flops(tc, m) / 1e12, 1) for m in (0, 1, 2)] \
        == [738.5, 257.1, 100.7]
