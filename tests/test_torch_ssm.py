"""The port's Mamba2 SSD layer and its kernel's plain version against the
JAX package, on the CPU.

On the CPU ``kernels/ssd/ops.ssd`` runs the kernel's plain version
(``ref.ssd_chunk_ref``); the JAX kernel runs in interpret mode, as the JAX
package's own tests run it. Inputs and weights are made with numpy from a
seed and handed to both. Tolerance: f32 1e-5 against the JAX package
(both sides compute in float32, in different orders), except 5e-5 for
the SSD scan itself: XLA and torch sum the cumulative log decay L over a
chunk in another order, which moves L (|L| up to ~45 here) by a few ulps,
and exp(L_q - L_k) passes that on (seen: 1.7e-5 on one element of 8192,
chunk 64). 1e-4 where the chunked algorithm is held against the
sequential recurrence (another algorithm: exp of a cumulative sum
against a product of exps over up to 64 steps), port against port.
The split-bf16 emulation of the ``"wgmma"`` kernel (bf16 x) is held
against the JAX kernel at the card's SSD levels, 2e-2 for bf16 y (one
rounding) and 1e-3 for Sc and Ltot, and its float32 parts also at 5e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jssd_ref
from repro.kernels.ssd.ssd_chunk import ssd_chunk_pallas
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd.ssd_chunk import select_ssd_variant, ssd_variant_of
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = dict(atol=5e-5, rtol=5e-5)
CARD_SSD_TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
                "float32": dict(atol=1e-3, rtol=1e-3)}
# one mamba2-130m layer at B=4, S=2048 (B, S, H, P, N, chunk)
SSD_PATH = (4, 2048, 24, 64, 128, 128)

# the JAX package's SSD_CASES (B, S, H, P, N, chunk), plus a padded one
SSD_CASES = [(2, 64, 4, 16, 8, 16), (1, 96, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16), (1, 128, 4, 16, 32, 64),
             (2, 50, 3, 16, 8, 16)]


def _ssd_inputs(case, seed=None):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(sum(case) if seed is None else seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# Configs and norms


def test_mamba2_config_equals_reference_field_for_field():
    want = jcfgs.get_config("mamba2-130m")
    got = tcfgs.get_config("mamba2-130m")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert "mamba2-130m" not in tcfgs.DIT_ARCHS
    # the reduced rule is the reference's: state 16, head_dim 16, chunk 16
    assert got.reduced().ssm == tcfgs.SSMConfig(state_dim=16, head_dim=16,
                                                chunk_size=16)


def test_moe_reduced_still_raises():
    # MoE configs reduce since the MoE slice of the port: by the
    # reference's rule (4 experts, top-2 at most, 1 shared at most,
    # expert width 32), field for field
    kw = dict(num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
              expert_d_ff=1408)
    got = dataclasses.replace(tcfgs.get_config("mamba2-130m"),
                              moe=tcfgs.MoEConfig(**kw)).reduced()
    want = dataclasses.replace(jcfgs.get_config("mamba2-130m"),
                               moe=jcfgs.MoEConfig(**kw)).reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.moe == tcfgs.MoEConfig(num_experts=4, num_experts_per_tok=2,
                                      num_shared_experts=1, expert_d_ff=32)


@pytest.mark.parametrize("zero_centered", [True, False])
def test_rms_norm_matches_reference(zero_centered):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                            zero_centered=zero_centered)
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           zero_centered=zero_centered)
    _close(got.numpy(), want)
    bf = tcommon.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale))
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# SSD pieces


@pytest.mark.parametrize("case", SSD_CASES[:4], ids=[f"s{i}" for i in range(4)])
def test_plain_ssd_chunk_matches_jax_kernel(case):
    """The kernel's plain version against ssd_chunk_pallas (interpret)."""
    chunk = case[-1]
    x, dt, A, Bm, Cm, _ = _ssd_inputs(case)
    want = ssd_chunk_pallas(*_j(x, dt, A, Bm, Cm), chunk=chunk, interpret=True)
    got = ref.ssd_chunk_ref(*_t(x, dt, A, Bm, Cm), chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w, **SSD_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", SSD_CASES, ids=[f"s{i}" for i in range(len(SSD_CASES))])
def test_ssd_ops_matches_jax_and_recurrence(case, with_state):
    chunk = case[-1]
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case)
    h0 = h0 if with_state else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = ops.ssd(*_t(x, dt, A, Bm, Cm), chunk, th0)
    jy, jh = jssd_ops.ssd(*_j(x, dt, A, Bm, Cm), chunk,
                          None if h0 is None else jnp.asarray(h0))
    _close(y.numpy(), jy, **SSD_TOL)
    _close(h.numpy(), jh, **SSD_TOL)
    # and the port's chunked algorithm and its sequential ground truth
    cy, ch = tssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk, th0)
    _close(cy.numpy(), y.numpy())
    _close(ch.numpy(), h.numpy())
    ry, rh = ref.ssd_recurrence_ref(*_t(x, dt, A, Bm, Cm), th0)
    _close(y.numpy(), ry.numpy(), atol=1e-4, rtol=1e-4)
    _close(h.numpy(), rh.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", SSD_CASES[1::2], ids=["s1", "s3"])
def test_ssd_chunked_and_recurrence_match_jax(case):
    chunk = case[-1]
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(case)
    for h_init in (None, h0):
        th = None if h_init is None else torch.from_numpy(h_init)
        jh0 = None if h_init is None else jnp.asarray(h_init)
        y, h = tssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk, th)
        jy, jh = jssm.ssd_chunked(*_j(x, dt, A, Bm, Cm), chunk, jh0)
        _close(y.numpy(), jy, **SSD_TOL)
        _close(h.numpy(), jh, **SSD_TOL)
        ry, rh = ref.ssd_recurrence_ref(*_t(x, dt, A, Bm, Cm), th)
        jry, jrh = jssd_ref.ssd_recurrence_ref(*_j(x, dt, A, Bm, Cm), jh0)
        _close(ry.numpy(), jry)
        _close(rh.numpy(), jrh)


def test_ssd_recurrent_step_matches_jax():
    x, dt, A, Bm, Cm, h0 = _ssd_inputs((2, 1, 3, 8, 16, 1))
    args = (h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    h, y = tssm.ssd_recurrent_step(*_t(*args))
    jh, jy = jssm.ssd_recurrent_step(*_j(*args))
    _close(h.numpy(), jh)
    _close(y.numpy(), jy)


def test_ssd_ops_counts_nothing_on_cpu_and_rejects_devices():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(SSD_CASES[0])
    ops.reset_launches()
    ops.ssd(*_t(x, dt, A, Bm, Cm), 16)
    ops.ssd(torch.from_numpy(x).bfloat16(), *_t(dt, A, Bm, Cm), 16)
    assert ops.ssd.launches == 0
    assert ops.ssd.launches_by_variant == {"wgmma": 0, "simt": 0}
    ops.ssd.launches, ops.ssd.launches_by_variant["wgmma"] = 3, 2
    ops.reset_launches()
    assert ops.ssd.launches == 0
    assert ops.ssd.launches_by_variant == {"wgmma": 0, "simt": 0}
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd(*(t.to("meta") for t in _t(x, dt, A, Bm, Cm)), 16)


# ---------------------------------------------------------------------------
# The wgmma kernel's selection and its split-bf16 arithmetic


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
def test_ssd_variant_at_the_path_shape(dtype, want):
    B, S, H, P, N, chunk = SSD_PATH
    assert select_ssd_variant(dtype, S, H, P, N, chunk, True) == want
    x = torch.zeros((B, 256, H, P), dtype=dtype)
    Bm = torch.zeros((B, 256, N))
    assert ssd_variant_of(x, Bm, Bm.clone(), chunk) == want


@pytest.mark.parametrize("case", SSD_CASES, ids=[f"s{i}" for i in range(len(SSD_CASES))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_variant_at_the_jax_cases_is_simt(case, dtype):
    """The JAX package's SSD_CASES are narrower than the wgmma tiles
    (P <= 32 with N <= 32, chunks of 16 to 64)."""
    B, S, H, P, N, chunk = case
    assert select_ssd_variant(dtype, S, H, P, N, chunk, True) == "simt"


@pytest.mark.parametrize("change, want", [
    ({}, "wgmma"),
    (dict(chunk=64), "wgmma"),
    (dict(P=32), "wgmma"),
    (dict(N=64), "wgmma"),
    (dict(H=25), "wgmma"),
    (dict(aligned=False), "simt"),
    (dict(P=16), "simt"),
    (dict(N=8), "simt"),
    (dict(chunk=32), "simt"),
    (dict(P=128), "simt"),
    (dict(N=96), "simt"),
    (dict(S=2000), "simt"),
])
def test_select_ssd_variant_bounds(change, want):
    B, S, H, P, N, chunk = SSD_PATH
    kw = dict(dtype=torch.bfloat16, S=S, H=H, P=P, N=N, chunk=chunk, aligned=True)
    kw.update(change)
    assert select_ssd_variant(**kw) == want


def test_ssd_variant_of_sees_a_misaligned_base():
    B, S, H, P, N, chunk = 1, 128, 2, 64, 128, 128
    x = torch.zeros((B, S, H, P), dtype=torch.bfloat16)
    Bm = torch.zeros((B, S, N))
    Cm = torch.zeros(B * S * N + 1)[1:].reshape(B, S, N)   # 4 bytes past an aligned base
    assert ssd_variant_of(x, Bm, Bm.clone(), chunk) == "wgmma"
    assert ssd_variant_of(x, Bm, Cm, chunk) == "simt"


@pytest.mark.parametrize("pieces, bits", [(2, 16), (3, 24)])
def test_split_bf16_reconstructs_float32(pieces, bits):
    rng = np.random.default_rng(pieces)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32))
    parts = ref.split_bf16(v, pieces)
    assert len(parts) == pieces and all(p.dtype == torch.bfloat16 for p in parts)
    back = sum(p.float() for p in parts)
    # at most half a unit in the last of `bits` significant bits, so
    # 2^-bits relative (3 pieces reach float32's own 2^-24: a few ulps)
    err = (back - v).abs() / v.abs()
    assert err.max().item() <= 2.0 ** -bits
    if pieces == 3:
        assert (back - v).abs().max().item() <= 4 * 2.0 ** -24 * v.abs().max().item()


@pytest.mark.parametrize("case", SSD_CASES[:4], ids=[f"s{i}" for i in range(4)])
def test_split_ssd_chunk_matches_jax_kernel_in_bf16(case):
    """The wgmma kernel's arithmetic (M in 2 bf16 pieces, B^T w in 3,
    bf16 x) against ssd_chunk_pallas (interpret) with the same bf16 x."""
    chunk = case[-1]
    x, dt, A, Bm, Cm, _ = _ssd_inputs(case)
    xb = torch.from_numpy(x).bfloat16()
    want = ssd_chunk_pallas(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                            *_j(dt, A, Bm, Cm), chunk=chunk, interpret=True)
    got = ref.ssd_chunk_split_ref(xb, *_t(dt, A, Bm, Cm), chunk)
    assert got[0].dtype == torch.bfloat16
    for g, w, kind in zip(got, want, ("bfloat16", "float32", "float32")):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.float().numpy(), np.asarray(w, dtype=np.float32), **CARD_SSD_TOL[kind])
    # Sc (3 pieces) and Ltot stay at the float32 level of the plain version
    for g, w in zip(got[1:], want[1:]):
        _close(g.numpy(), w, **SSD_TOL)


# ---------------------------------------------------------------------------
# The Mamba2 layer


def _layer(cfg, seed: int = 0):
    """A Mamba2 layer of ``cfg`` in both packages: the reference's init with
    the zero-initialized leaves (A_log, dt_bias, conv_b, norm) made
    non-zero, so the decay varies across heads and no path hides."""
    p = jax.tree.map(np.asarray, jcommon.init_tree(
        jssm.ssm_schema(cfg.d_model, cfg.ssm), jax.random.PRNGKey(seed),
        jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for key, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("conv_b", 0.1)):
        p[key] = (rng.standard_normal(p[key].shape) * scale).astype(np.float32)
    p["norm"]["scale"] = (rng.standard_normal(p["norm"]["scale"].shape)
                          * 0.1).astype(np.float32)
    return jax.tree.map(jnp.asarray, p), convert.params_from_numpy(p, device="cpu")


@pytest.fixture(scope="module")
def mamba():
    cfg = jcfgs.get_config("mamba2-130m").reduced()
    jp, tp = _layer(cfg)
    return cfg, jp, tp


def test_ssm_schema_and_state_match_reference(mamba):
    cfg, jp, tp = mamba
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = tcommon.tree_map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    assert tcommon.tree_map(lambda s: s.shape, tssm.ssm_schema(cfg.d_model, cfg.ssm)) == \
        jax.tree.map(lambda s: s.shape, jssm.ssm_schema(cfg.d_model, cfg.ssm),
                     is_leaf=lambda s: isinstance(s, jcommon.ParamSpec))
    assert tssm.ssm_dims(cfg.d_model, cfg.ssm) == jssm.ssm_dims(cfg.d_model, cfg.ssm)
    js = jssm.init_ssm_state(2, cfg.d_model, cfg.ssm, jnp.float32)
    ts = tssm.init_ssm_state(2, cfg.d_model, cfg.ssm, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}


@pytest.mark.parametrize("S", [40, 32])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_apply_matches_reference(mamba, use_kernel, S):
    """One Mamba2 layer at mamba2-130m.reduced(), no state, both branches."""
    cfg, jp, tp = mamba
    u = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, jstate = jssm.ssm_apply(jp, jnp.asarray(u), cfg.ssm, cfg.d_model,
                                  use_kernel=use_kernel)
    got, tstate = tssm.ssm_apply(tp, torch.from_numpy(u), cfg.ssm, cfg.d_model,
                                 use_kernel=use_kernel)
    _close(got.numpy(), want)
    _close(tstate["h"].numpy(), jstate["h"])
    _close(tstate["conv"].numpy(), jstate["conv"])


def test_ssm_apply_with_state_matches_reference(mamba):
    """Prefill with a carried state, then single-token decode steps."""
    cfg, jp, tp = mamba
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    js = jssm.init_ssm_state(2, cfg.d_model, cfg.ssm, jnp.float32)
    ts = tssm.init_ssm_state(2, cfg.d_model, cfg.ssm, torch.float32, device="cpu")
    for lo, hi in ((0, 20), (20, 21), (21, 22), (22, 24)):
        jy, js = jssm.ssm_apply(jp, jnp.asarray(u[:, lo:hi]), cfg.ssm,
                                cfg.d_model, js)
        ty, ts = tssm.ssm_apply(tp, torch.from_numpy(u[:, lo:hi]), cfg.ssm,
                                cfg.d_model, ts)
        _close(ty.numpy(), jy)
        _close(ts["h"].numpy(), js["h"])
        _close(ts["conv"].numpy(), js["conv"])


def test_streaming_state_equivalence():
    """Full-sequence layer == prefill on the first part + step-by-step
    decode, port against port (as tests/test_ssm.py holds the reference)."""
    cfg = tcfgs.SSMConfig(state_dim=8, head_dim=16, chunk_size=8)
    d = 32
    params = tcommon.init_tree(tssm.ssm_schema(d, cfg),
                               torch.Generator().manual_seed(0), torch.float32)
    B, S = 2, 20
    u = torch.randn((B, S, d), generator=torch.Generator().manual_seed(1))
    for use_kernel in (False, True):
        full, _ = tssm.ssm_apply(params, u, cfg, d, use_kernel=use_kernel)
        state = tssm.init_ssm_state(B, d, cfg, torch.float32, device="cpu")
        half, state = tssm.ssm_apply(params, u[:, :12], cfg, d, state)
        outs = [half]
        for i in range(12, S):
            y, state = tssm.ssm_apply(params, u[:, i:i + 1], cfg, d, state,
                                      use_kernel=use_kernel)
            outs.append(y)
        torch.testing.assert_close(torch.cat(outs, dim=1), full,
                                   atol=2e-4, rtol=2e-4)


def test_kernel_branch_with_carried_state_raises(mamba):
    """The reference's kernel branch drops h0 (ssm.py:189), so the port
    refuses a carried state with S > 1 rather than differ silently."""
    cfg, _, tp = mamba
    state = tssm.init_ssm_state(2, cfg.d_model, cfg.ssm, torch.float32, device="cpu")
    u = torch.zeros((2, 5, cfg.d_model))
    with pytest.raises(NotImplementedError, match="queue 3"):
        tssm.ssm_apply(tp, u, cfg.ssm, cfg.d_model, state, use_kernel=True)
    # one token with a state is the decode step, on either branch
    y, _ = tssm.ssm_apply(tp, u[:, :1], cfg.ssm, cfg.d_model, state,
                          use_kernel=True)
    assert y.shape == (2, 1, cfg.d_model)
