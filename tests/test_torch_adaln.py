"""The fused adaLN kernels' plain version and wrappers on the CPU
(``kernels/adaln``): the plain version is the packed DiT block's chain of
PyTorch ops, bit for bit; the wrappers route CPU tensors to it and count
no launch; the launch plan and the binding's refusals are host logic.

The packed block through the wrappers is held against the chain it
replaced, bit for bit, and the packed forward against the JAX package in
``tests/test_torch_packing.py`` (float32 1e-5). The kernels themselves run
only on a card: ``tests/test_torch_gpu.py`` (marked ``gpu``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_adaln_checks import norm_matches
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.kernels.adaln import adaln as adaln_mod
from repro_torch.kernels.adaln import ops
from repro_torch.kernels.adaln.ref import (adaln_norm_ref,
                                           adaln_residual_norm_ref,
                                           segment_rows)
from repro_torch.models import dit as dit_mod

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (segment token counts, row capacity): a full layout, mixed 256 + 64 rows
# with a padding tail, and 64-token segments only
LAYOUTS = {"full": ((256, 3), 256), "mixed": ((256, 2), (64, 7)),
           "weak": ((64, 5),)}


def _plan(name: str):
    """(token_idx [R, C], number of table rows) of a layout's pack plan."""
    groups = LAYOUTS[name]
    if name == "full":
        groups, cap = (groups[0],), groups[1]
    else:
        cap = 256
    plan = packing._pack_plan(tuple(groups), cap)
    return torch.from_numpy(plan.token_idx), plan.n_seg + 1


def _inputs(name: str, d: int, k: int, dtype: torch.dtype, seed: int):
    token_idx, rows = _plan(name)
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(token_idx.shape + (d,), generator=g) * 3 + 0.5).to(dtype)
    y = torch.randn(token_idx.shape + (d,), generator=g).to(dtype)
    table = (torch.randn((rows, k * d), generator=g) * 0.3).to(dtype)
    return x, y, table, token_idx


def _chain_norm(x, ada, token_idx, i_shift, i_scale, k):
    """The packed block's norm as it was written: the table gathered to
    tokens, chunked, ``_ln`` then the modulation."""
    parts = torch.chunk(ada[token_idx], k, dim=-1)
    return dit_mod._ln(x) * (1.0 + parts[i_scale]) + parts[i_shift]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("d", [16, 40])
def test_plain_version_is_the_block_chain_bit_for_bit(dtype, layout, d):
    x, y, table, token_idx = _inputs(layout, d, 6, DTYPES[dtype], d)
    for sh, sc in ((0, 1), (3, 4)):
        assert torch.equal(adaln_norm_ref(x, table, token_idx, sh, sc),
                           _chain_norm(x, table, token_idx, sh, sc, 6))
    g1 = torch.chunk(table[token_idx], 6, dim=-1)[2]
    want_x = x + g1 * y
    got_x, got_h = adaln_residual_norm_ref(x, y, table, token_idx, 2, 3, 4)
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_h, _chain_norm(want_x, table, token_idx, 3, 4, 6))
    alone, none = adaln_residual_norm_ref(x, y, table, token_idx, 5)
    assert none is None
    assert torch.equal(alone, x + torch.chunk(table[token_idx], 6, -1)[5] * y)
    # the final layer's [S + 1, 2d] table
    final = table[:, :2 * d]
    assert torch.equal(adaln_norm_ref(x, final, token_idx, 0, 1),
                       _chain_norm(x, final, token_idx, 0, 1, 2))


def test_padding_reads_the_table_last_row():
    x, _, table, token_idx = _inputs("mixed", 16, 2, torch.float32, 3)
    pad = token_idx == table.shape[0] - 1
    assert pad.any() and (~pad).any()
    h = adaln_norm_ref(x, table, token_idx, 0, 1)
    last = table[-1]
    want = dit_mod._ln(x[pad]) * (1.0 + last[16:]) + last[:16]
    assert torch.equal(h[pad], want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrappers_route_cpu_tensors_to_the_plain_version(dtype):
    x, y, table, token_idx = _inputs("mixed", 24, 6, DTYPES[dtype], 5)
    ops.reset_launches()
    assert torch.equal(ops.adaln_norm(x, table, token_idx, 0, 1),
                       adaln_norm_ref(x, table, token_idx, 0, 1))
    got = ops.adaln_residual_norm(x, y, table, token_idx, 2, 3, 4)
    want = adaln_residual_norm_ref(x, y, table, token_idx, 2, 3, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got_x, got_h = ops.adaln_residual_norm(x, y, table, token_idx, 5)
    assert got_h is None
    assert torch.equal(got_x, adaln_residual_norm_ref(x, y, table, token_idx, 5)[0])
    assert ops.adaln_norm.launches == ops.adaln_residual_norm.launches == 0


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4, 8), device="meta")
    idx = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    table = torch.empty((1, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.adaln_norm(meta, table, idx, 0, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.adaln_residual_norm(meta, meta, table, idx, 0)


def _old_packed_block(p, x, seg_c, token_idx, cfg, mode, segment_ids,
                      attn_backend="auto", block_map=None):
    """``core/packing._packed_block`` as it was before the fused kernels:
    the [R, C, 6d] gather and the chain of element-wise ops."""
    H = cfg.attn.num_heads
    dtype = x.dtype
    ada = dit_mod._linear(F.silu(seg_c.float()).to(dtype),
                          p["ada"]["w"], p["ada"]["b"])
    ada = ada[token_idx]
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(ada, 6, dim=-1)
    lora = p.get("lora", {})
    h = dit_mod._ln(x) * (1.0 + sc1) + sh1
    attn = dit_mod._mha(p["attn"], h, H, lora=lora.get("attn"), mode=mode,
                        segment_ids=segment_ids, attn_backend=attn_backend,
                        block_map=block_map)
    x = x + g1 * attn
    h2 = dit_mod._ln(x) * (1.0 + sc2) + sh2
    mlp_lora = lora.get("mlp", {})
    h2 = dit_mod._linear(h2, p["mlp"]["w_in"], p["mlp"]["b_in"],
                         lora=mlp_lora.get("w_in"), mode=mode)
    h2 = F.gelu(h2.float(), approximate="tanh").to(dtype)
    h2 = dit_mod._linear(h2, p["mlp"]["w_out"], p["mlp"]["b_out"],
                         lora=mlp_lora.get("w_out"), mode=mode)
    return x + g2 * h2


def _small_xl(dtype: str):
    cfg = get_config("dit-xl-2").reduced()
    return dataclasses.replace(
        cfg, param_dtype=dtype, compute_dtype=dtype,
        dit=dataclasses.replace(cfg.dit, latent_shape=(1, 32, 32, 4)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_packed_forward_equals_the_chain_it_replaced(dtype, monkeypatch):
    """A whole packed forward (mixed modes, a padding tail) through the
    wrappers on the CPU equals the same forward through the old block,
    bit for bit: the final adaLN included."""
    cfg = _small_xl(dtype)
    gen = torch.Generator().manual_seed(7)
    params = dit_mod.init_dit(cfg, gen)
    for node in (params["final"]["ada"], params["blocks"]["ada"]):
        node["w"] = (torch.randn(node["w"].shape, generator=gen)
                     * 0.05).to(node["w"].dtype)
    groups = ((0, 2), (1, 5))
    xs = [torch.randn((n,) + cfg.dit.latent_shape, generator=gen)
          for _m, n in groups]
    ts = [torch.randint(0, 100, (n,), generator=gen) for _m, n in groups]
    cs = [torch.randint(0, 10, (n,), generator=gen) for _m, n in groups]
    new = packing.packed_mixed_forward(params, cfg, groups, xs, ts, cs)

    def old_final(x, table, token_idx, shift_col, scale_col):
        return _chain_norm(x, table, token_idx, shift_col, scale_col,
                           table.shape[1] // x.shape[-1])

    monkeypatch.setattr(packing, "_packed_block", _old_packed_block)
    monkeypatch.setattr(packing.adaln_ops, "adaln_norm", old_final)
    old = packing.packed_mixed_forward(params, cfg, groups, xs, ts, cs)
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_norm_matches_accepts_one_ulp_and_refuses_faults():
    x, y, table, token_idx = _inputs("mixed", 32, 6, torch.bfloat16, 11)
    h = adaln_norm_ref(x, table, token_idx, 0, 1)
    assert norm_matches(h, x, table, token_idx, 0, 1).all()
    # LN rounded one ulp up everywhere: still within the check
    up = (dit_mod._ln(x).view(torch.int16) + 1).view(torch.bfloat16)
    h_up = (up * (1.0 + segment_rows(table, token_idx, 1, 32))
            + segment_rows(table, token_idx, 0, 32))
    assert norm_matches(h_up, x, table, token_idx, 0, 1).all()
    # the next segment's row, and the scale read from the gate's column
    nxt = (token_idx + 1) % table.shape[0]
    assert not norm_matches(adaln_norm_ref(x, table, nxt, 0, 1),
                            x, table, token_idx, 0, 1).all()
    assert not norm_matches(adaln_norm_ref(x, table, token_idx, 0, 2),
                            x, table, token_idx, 0, 1).all()


@pytest.mark.parametrize("n_tok,d,itemsize,want", [
    # the served layouts at DiT-XL/2's width: one warp a row, 9 chunks
    (8192, 1152, 2, adaln_mod.LaunchPlan(32, 9, 8, 4, 256)),
    (256, 1152, 2, adaln_mod.LaunchPlan(32, 9, 2, 1, 128)),
    (8192, 1152, 4, adaln_mod.LaunchPlan(64, 5, 1, 8, 1024)),
    (300, 64, 2, adaln_mod.LaunchPlan(32, 1, 3, 1, 100)),
    (4000, 1536, 2, adaln_mod.LaunchPlan(32, 12, 8, 2, 250)),
    (4000, 2048, 2, adaln_mod.LaunchPlan(64, 8, 1, 4, 1000)),
    (1000, 8192, 4, adaln_mod.LaunchPlan(256, 8, 1, 4, 250)),
])
def test_launch_plan_at_known_shapes(n_tok, d, itemsize, want):
    assert adaln_mod.launch_plan(n_tok, d, itemsize, 132) == want


@pytest.mark.parametrize("d", [8, 64, 1152, 1536, 2048, 2056, 4096, 8192])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n_tok", [1, 255, 8192, 50000])
def test_launch_plan_covers_every_token(d, itemsize, n_tok):
    p = adaln_mod.launch_plan(n_tok, d, itemsize, 132)
    nch = d // 4
    assert p.row_threads in adaln_mod.ROW_THREADS
    # one warp a row as far as the chunks a thread allow
    assert (p.row_threads == 32) == (nch <= 32 * adaln_mod.MAX_CHUNKS[itemsize])
    assert 1 <= p.chunks <= adaln_mod.MAX_CHUNKS[itemsize]
    assert (p.chunks - 1) * p.row_threads < nch <= p.chunks * p.row_threads
    assert p.groups_per_cta * p.row_threads <= adaln_mod.CTA_THREADS
    assert p.row_threads == 32 or p.groups_per_cta == 1
    covered = p.grid * p.groups_per_cta * p.tok_per_group
    assert covered >= n_tok
    # no CTA is left without a token
    assert (p.grid - 1) * p.groups_per_cta * p.tok_per_group < n_tok


@pytest.mark.parametrize("d", [0, 12, 8200, 9000])
def test_launch_plan_refuses_widths(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        adaln_mod.launch_plan(100, d, 2, 132)


def _refusal_cases():
    x = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    table = torch.zeros((3, 96), dtype=torch.bfloat16)
    idx = torch.zeros((2, 4), dtype=torch.int64)
    return [
        ("nothing", dict(x=x, table=table, token_idx=idx), ValueError),
        ("gate without y", dict(x=x, table=table, token_idx=idx, gate_col=2),
         ValueError),
        ("shift without scale", dict(x=x, table=table, token_idx=idx,
                                     shift_col=0), ValueError),
        ("float16", dict(x=x.half(), table=table.half(), token_idx=idx,
                         shift_col=0, scale_col=1), TypeError),
        ("d 12", dict(x=torch.zeros((2, 4, 12)), table=torch.zeros((3, 72)),
                      token_idx=idx, shift_col=0, scale_col=1), ValueError),
        ("table width", dict(x=x, table=table[:, :90], token_idx=idx,
                             shift_col=0, scale_col=1), ValueError),
        ("column", dict(x=x, table=table, token_idx=idx, shift_col=0,
                        scale_col=6), ValueError),
        ("token_idx shape", dict(x=x, table=table, token_idx=idx[:1],
                                 shift_col=0, scale_col=1), ValueError),
        ("token_idx int32", dict(x=x, table=table, token_idx=idx.int(),
                                 shift_col=0, scale_col=1), TypeError),
        ("table dtype", dict(x=x, table=table.float(), token_idx=idx,
                             shift_col=0, scale_col=1), TypeError),
        ("y shape", dict(x=x, table=table, token_idx=idx, y=x[:1],
                         gate_col=2), ValueError),
        ("x strided", dict(x=x.transpose(0, 1), table=table,
                           token_idx=idx.t().contiguous(), shift_col=0,
                           scale_col=1), ValueError),
    ]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_binding_refuses_what_the_kernel_does_not_take(case):
    _name, kw, exc = case
    with pytest.raises(exc):
        adaln_mod.adaln_cuda(**kw)


def test_packed_forward_counts_no_launch_on_the_cpu():
    cfg = _small_xl("float32")
    params = dit_mod.init_dit(cfg, torch.Generator().manual_seed(0))
    groups = ((1, 3),)
    x = [torch.randn((3,) + cfg.dit.latent_shape)]
    ops.reset_launches()
    out = packing.packed_mixed_forward(params, cfg, groups, x,
                                       [torch.zeros(3, dtype=torch.int64)],
                                       [torch.zeros(3, dtype=torch.int64)])
    assert np.isfinite(out[0].numpy()).all()
    assert ops.adaln_norm.launches == ops.adaln_residual_norm.launches == 0
