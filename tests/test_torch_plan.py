"""The port's dry-run planner (``launch/{mesh,specs,roofline,dryrun}.py``
and ``ModelConfig.active_params``) against the JAX package's.

Equal exactly, for every config, cell and production mesh ((16 x 16) and
(2 x 16 x 16)): ``num_params`` / ``active_params`` and ``model_flops``;
``all_cells``, ``cell_is_skipped`` and ``choose_microbatches``; each
input's chunk a device (the reference's side is ``NamedSharding`` on a
``jax.sharding.AbstractMesh``: ``shard_shape``); parameter and AdamW
moment bytes a device for every profile; ``roofline_terms`` handed the
reference's v5e constants; the ring wire-byte rule against
``parse_collectives``.

The planner's own readings: the ``meta`` FLOPs of a DiT forward equal
``dit_nfe_flops`` plus the products that formula leaves out (the
timestep MLP, 2 B (256 d + d²), and the PI-resize of the flexible
embedding and de-embedding weights, per forward); the resident bytes a
rank that ``chip_smoke.py`` phase 15 measured on (2 x 2) are reproduced; a sweep of reduced cells
writes its records and a full-width cell creates no tensor off ``meta``
but the model's few host constants.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported (its first lines), so the import saves and restores the variable.
"""
import dataclasses
import importlib
import json
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pt_leaves
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.core import scheduler as jsched
from repro.launch import roofline as jrl
from repro.launch import specs as jsp
from repro_torch import configs as tcfgs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as trl
from repro_torch.launch import specs as tsp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import sharding as tshard

PROFILES = ("fsdp2d", "fsdp2d_sp", "tp_only", "dp")
MESHES = {"16x16": False, "2x16x16": True}
V5E = trl.Hardware(name="v5e", peak_flops=jrl.PEAK_FLOPS, hbm_bw=jrl.HBM_BW,
                   hbm_bytes=jrl.HBM_BYTES, node_link_bw=jrl.ICI_BW,
                   network_bw=jrl.ICI_BW)


def _import_reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


jdry = _import_reference_dryrun()


class _JMesh:
    """The axis names and sizes the reference's rules read."""

    def __init__(self, layout):
        self.axis_names = tuple(layout.axis_names)
        self.devices = np.empty(tuple(layout.shape))
        self.abstract = AbstractMesh(tuple(layout.shape), self.axis_names)


@pytest.fixture
def jmesh_of(monkeypatch):
    """The reference's specs module on an abstract mesh: its
    ``NamedSharding`` takes the mesh's ``AbstractMesh``."""
    monkeypatch.setattr(jsp, "NamedSharding",
                        lambda mesh, spec: JNamedSharding(mesh.abstract, spec))
    return lambda multi_pod: _JMesh(make_production_mesh(multi_pod=multi_pod))


def _local_shapes(tree):
    return [tuple(s.sharding.shard_shape(s.shape)) for s in jax.tree.leaves(tree)]


def _port_shapes(tree):
    return [tuple(t.shape) for t in pt_leaves(tree)]


def _leaves_sorted(tree):
    """Leaves in sorted-key order (jax.tree's), of nested dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# Configs, cells, microbatches


@pytest.mark.parametrize("name", sorted(jcfgs.REGISTRY))
def test_params_and_model_flops_equal_reference(name):
    jc, tc = jcfgs.get_config(name), tcfgs.get_config(name)
    assert tc.num_params() == jc.num_params()
    assert tc.active_params() == jc.active_params()
    for kind in ("train", "serve"):
        for tokens in (1, 4096, 256 * 4096):
            assert trl.model_flops(tc, kind, tokens) == jrl.model_flops(jc, kind, tokens)


def test_cells_and_skips_equal_reference():
    assert tdry.all_cells() == jdry.all_cells()
    assert [s.name for s in tcfgs.LM_SHAPES] == [s.name for s in jcfgs.LM_SHAPES]
    for arch, shape in jdry.all_cells():
        assert tcfgs.cell_is_skipped(arch, shape) == jcfgs.cell_is_skipped(arch, shape)
    assert tcfgs.ASSIGNED_ARCHS == jcfgs.ASSIGNED_ARCHS
    assert tcfgs.DIT_ARCHS == jcfgs.DIT_ARCHS


@pytest.mark.parametrize("mesh", list(MESHES))
def test_production_mesh_and_microbatches_equal_reference(mesh, jmesh_of):
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    jm = jmesh_of(MESHES[mesh])
    assert tshard.axis_names(layout) == jm.axis_names
    assert tuple(layout.shape) == jm.devices.shape
    for arch in jcfgs.ASSIGNED_ARCHS:
        for sp_on in (False, True):
            jc = dataclasses.replace(jcfgs.get_config(arch), sequence_parallel=sp_on)
            tc = dataclasses.replace(tcfgs.get_config(arch), sequence_parallel=sp_on)
            for js, ts in zip(jcfgs.LM_SHAPES, tcfgs.LM_SHAPES):
                assert (tsp.choose_microbatches(tc, ts, layout)
                        == jsp.choose_microbatches(jc, js, jm)), (arch, js.name)


# ---------------------------------------------------------------------------
# Each device's inputs and resident bytes


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cell_inputs_chunks_equal_reference(mesh, jmesh_of):
    """Every cell's inputs: each device's chunk shape and dtype."""
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    jm = jmesh_of(MESHES[mesh])
    for arch, shape in jdry.all_cells():
        jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
        if jc.family == "dit":
            want = jsp.dit_inputs(jc, shape, jm)
            got = tsp.dit_inputs(tc, shape, layout)
            keys = [k for k in want if k != "key"]       # the port draws t, noise
            assert [_local_shapes(want[k]) for k in keys] == \
                [_port_shapes(got[k]) for k in keys], (arch, shape)
            continue
        if jcfgs.cell_is_skipped(arch, shape):
            continue
        js, ts = jcfgs.get_shape(shape), tcfgs.get_shape(shape)
        fn = {"train": "train_inputs", "prefill": "prefill_inputs",
              "decode": "decode_inputs"}[js.kind]
        want, got = getattr(jsp, fn)(jc, js, jm), getattr(tsp, fn)(tc, ts, layout)
        assert _local_shapes(want) == _port_shapes(_leaves_sorted(got)), (arch, shape)
        assert [str(s.dtype) for s in jax.tree.leaves(want)] == \
            [str(t.dtype).replace("torch.", "") for t in _leaves_sorted(got)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resident_bytes_equal_reference(mesh, jmesh_of):
    """Parameter and moment bytes a device, every config and profile: the
    reference's ``abstract_params`` / ``abstract_opt_state`` shards."""
    layout = make_production_mesh(multi_pod=MESHES[mesh])
    jm = jmesh_of(MESHES[mesh])
    for name in sorted(jcfgs.REGISTRY):
        jc, tc = jcfgs.get_config(name), tcfgs.get_config(name)
        big = jc.family != "dit" and jc.num_params() > 5e10
        opt_dt = jax.numpy.bfloat16 if big else jax.numpy.float32
        for profile in PROFILES:
            jp, _ = jsp.abstract_params(jc, jm, profile)
            jo = jsp.abstract_opt_state(jp, jm, opt_dt)

            def nbytes(tree):
                return sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
                           for s in jax.tree.leaves(tree))
            got = tdry.resident_bytes(tc, layout, profile)
            assert got == {"param_bytes": nbytes(jp),
                           "opt_bytes": nbytes({"m": jo["m"], "v": jo["v"]})}, \
                (name, profile)


def test_reproduces_measured_bytes_a_rank():
    """``chip_smoke.py`` phase 15 measured these resident parameter +
    moment bytes a rank on (2 x 2) (bf16 weights, float32 moments): the
    whole DiT-XL/2, and since its cut for time its 14 layers."""
    layout = tshard.AxisLayout(("data", "model"), (2, 2))
    cases = [("dit-xl-2", {}, "fsdp2d", 1_692_272_000),
             ("dit-xl-2", dict(num_layers=14), "fsdp2d", 855_309_440),
             ("gemma2-9b", dict(num_layers=2, sequence_parallel=True,
                                remat="block"), "fsdp2d_sp", 3_284_825_600),
             ("deepseek-moe-16b", dict(num_layers=2), "fsdp2d", 3_988_572_160)]
    for arch, over, profile, want in cases:
        cfg = dataclasses.replace(tcfgs.get_config(arch), **over)
        got = tdry.resident_bytes(cfg, layout, profile)
        assert got["param_bytes"] + got["opt_bytes"] == want, arch


# ---------------------------------------------------------------------------
# Roofline arithmetic


def test_roofline_terms_on_v5e_constants_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(5):
        cost = {"flops": float(rng.integers(1, 10**15)),
                "bytes accessed": float(rng.integers(1, 10**12))}
        coll = {k: {"count": int(rng.integers(0, 9)),
                    "operand_bytes": float(rng.integers(0, 10**10)),
                    "result_bytes": float(rng.integers(0, 10**10)),
                    "wire_bytes": float(rng.integers(0, 10**10))}
                for k in jrl.COLLECTIVES}
        for mf in (None, float(rng.integers(1, 10**16))):
            want = jrl.roofline_terms(cost, coll, 256, mf)
            got = trl.roofline_terms(cost, coll, 256, mf, hw=V5E)
            assert got == want
    assert trl.COLLECTIVES == jrl.COLLECTIVES


def test_wire_bytes_rule_equals_parse_collectives():
    hlo = "\n".join([
        "  ag = bf16[64,128]{1,0} all-gather(bf16[16,128]{1,0} p0), dimensions={0}",
        "  ar = f32[1024]{0} all-reduce(f32[1024]{0} p1), to_apply=add",
        "  rs = f32[256]{0} reduce-scatter(f32[1024]{0} p2), dimensions={0}",
        "  aa = bf16[8,64]{1,0} all-to-all(bf16[8,64]{1,0} p3), dimensions={0}"])
    parsed = jrl.parse_collectives(hlo)
    for kind, rec in parsed.items():
        if rec["count"]:
            assert trl.wire_bytes(kind, rec["operand_bytes"],
                                  rec["result_bytes"]) == rec["wire_bytes"]


def test_axis_links_of_the_production_meshes():
    hw = trl.H100_SXM
    one = make_production_mesh()
    assert trl.axis_link_bw(one, "model", hw) == hw.network_bw      # 16 > 8 cards
    assert trl.axis_link_bw(one, "data", hw) == hw.network_bw
    small = tshard.AxisLayout(("data", "model"), (4, 2))
    assert trl.axis_link_bw(small, "model", hw) == hw.node_link_bw  # 2 cards
    assert trl.axis_link_bw(small, "data", hw) == hw.node_link_bw   # 4 x 2 = 8
    assert trl.axis_link_bw(tshard.AxisLayout(("data", "model"), (2, 8)),
                            "data", hw) == hw.network_bw


# ---------------------------------------------------------------------------
# The planner's traces


def port_cfg(jcfg):
    """The JAX package's DiT ModelConfig as the port's (same fields)."""
    from repro_torch.configs import base as tbase
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["attn"] = tbase.AttnConfig(**dataclasses.asdict(jcfg.attn))
    kw["dit"] = tbase.DiTConfig(**dataclasses.asdict(jcfg.dit))
    return tbase.ModelConfig(**kw)


@pytest.mark.parametrize("mode", [0, 1])
def test_meta_flops_of_a_dit_forward_explained(tiny_dit_cfg, mode):
    """Counted FLOPs of one forward = B x ``dit_nfe_flops`` (the reference's)
    + the timestep MLP, 2 B (256 d + d²), + the PI-resize products of the
    embedding weight (2 n_p n_u c_in d), the de-embedding weight (2 d
    c_out n_u n_p) and its bias (2 c_out n_u n_p): n_p pixels a patch at
    this mode, n_u at the underlying patch size."""
    jcfg = dataclasses.replace(tiny_dit_cfg, dit=dataclasses.replace(
        tiny_dit_cfg.dit, flex_patch_sizes=((1, 4, 4),),
        underlying_patch_size=(1, 4, 4)))
    cfg = port_cfg(jcfg)
    B, d = 3, cfg.d_model
    n_p = math.prod(((1, 2, 2), (1, 4, 4))[mode])
    n_u = math.prod(cfg.dit.underlying_patch_size)
    c_in, c_out = cfg.dit.latent_shape[-1], 2 * cfg.dit.latent_shape[-1] \
        if cfg.dit.learn_sigma else cfg.dit.latent_shape[-1]
    gap = (2 * B * (256 * d + d * d) + 2 * n_p * n_u * c_in * d
           + 2 * d * c_out * n_u * n_p + 2 * c_out * n_u * n_p)
    got = tdry.plan_dit_forward(cfg, B, mode)["flops"]
    assert got == B * jsched.dit_nfe_flops(jcfg, mode) + gap


def test_dit_xl2_forward_flops_reproduce_the_full_width_count():
    """At DiT-XL/2, B=8: the same rule, and the counts the chip phase
    holds the card's FLOPs against (1,897.945 / 464.706 GFLOP)."""
    cfg, jcfg = tcfgs.get_config("dit-xl-2"), jcfgs.get_config("dit-xl-2")
    got = [tdry.plan_dit_forward(cfg, 8, m)["flops"] for m in (0, 1)]
    assert got == [1_897_944_515_584.0, 464_705_818_624.0]
    assert [round(g - 8 * jsched.dit_nfe_flops(jcfg, m)) for m, g in
            enumerate(got)] == [27_722_752, 33_034_240]


class _Devices(TorchDispatchMode):
    """Every tensor an op makes that is not on ``meta``."""

    def __init__(self):
        super().__init__()
        self.off_meta = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.off_meta += [(str(func), t.device.type, t.numel() * t.element_size())
                          for t in pt_leaves(out)
                          if isinstance(t, torch.Tensor) and t.device.type != "meta"]
        return out


def test_full_width_cells_allocate_nothing(tmp_path):
    """Full-width cells on the production mesh: every tensor is ``meta``
    but the model's host constants (a PI-resize matrix, the schedule's
    tables: at most a few KB, on the CPU); the record has the reference's
    fields and a dense-backend count."""
    with _Devices() as seen:
        recs = [tdry.run_cell("dit-xl-2", s, out_path=tmp_path / f"{s}.json")
                for s in ("train_base", "serve_powerful")]
        recs.append(tdry.run_cell("gemma2-9b", "decode_32k"))
    assert all(dev == "cpu" and n <= 8192 for _, dev, n in seen.off_meta), \
        seen.off_meta
    for rec in recs:
        assert rec["status"] == "ok"
        for key in ("memory_analysis", "cost_analysis", "collectives",
                    "roofline", "sharded_args_bytes_per_device", "params",
                    "active_params", "n_devices"):
            assert key in rec
        assert rec["n_devices"] == 256
        r = rec["roofline"]
        assert r["dominant"] in ("compute", "memory", "collective")
        assert 0 < r["useful_flops_ratio"] < 1
    on_disk = json.loads((tmp_path / "train_base.json").read_text())
    assert on_disk["roofline"] == pytest.approx(recs[0]["roofline"])
    # DiT-XL/2 at 256 rows under 'dp': 16 a device; each rank along
    # 'model' computes them whole, so the useful share reads ~1/16
    assert recs[0]["profile"] == "dp"
    assert 0.5 / 16 < recs[0]["roofline"]["useful_flops_ratio"] < 1.5 / 16


def test_flash_swap_is_noted(monkeypatch):
    """A step that resolves attention to the flash kernel is planned on the
    dense path and its record says so: a train cell's step raises on the
    card there (the kernel has no backward). With every sequence long,
    'auto' resolves to the kernel; at DiT-XL/2's own length it does not."""
    from repro_torch.models import attention as tattn
    cfg = tcfgs.get_config("dit-xl-2").reduced()
    one = tshard.AxisLayout(("data", "model"), (1, 1))

    def plan(shape):
        return tdry.run_cell("dit-xl-2", shape, mesh=one, cfg=cfg, batch=2)
    assert "attention" not in plan("train_base")
    monkeypatch.setattr(tattn, "BLOCKED_ATTN_THRESHOLD", 0)
    assert plan("train_base")["attention"] == tdry.FLASH_TRAIN_NOTE
    assert plan("serve_powerful")["attention"] == tdry.FLASH_NOTE


def _reduced_cell(arch, shape_name):
    """``run_cell``'s overrides for the arch's reduced config, at most 64
    tokens a sequence and 8 rows a batch."""
    cfg = tcfgs.get_config(arch)
    if cfg.family == "dit":
        return {"cfg": cfg.reduced(),
                "batch": min(tsp.DIT_SHAPES[arch][shape_name], 8)}
    shape = tcfgs.get_shape(shape_name)
    return {"cfg": cfg.reduced(),
            "shape": dataclasses.replace(
                shape, seq_len=min(shape.seq_len, 64),
                global_batch=min(shape.global_batch, 8))}


def test_reduced_sweep_writes_records(tmp_path, capsys, monkeypatch):
    """The sweep over every cell, each at its arch's reduced config and
    short shapes on a (2 x 2) mesh shape: records written, the skipped
    cells skipped."""
    layout = tshard.AxisLayout(("data", "model"), (2, 2))
    planned = tdry.run_cell
    monkeypatch.setattr(tdry, "RESULTS", tmp_path)
    monkeypatch.setattr(tdry, "make_production_mesh",
                        lambda multi_pod=False: layout)
    monkeypatch.setattr(
        tdry, "run_cell", lambda arch, shape, mp, profile, out: planned(
            arch, shape, mp, profile, out, mesh=layout,
            **_reduced_cell(arch, shape)))
    recs = tdry.sweep(profile="fsdp2d", only_missing=False)
    assert "[sweep] 49 cells" in capsys.readouterr().out
    assert [(r["arch"], r["shape"]) for r in recs] == tdry.all_cells()
    for arch, shape in tdry.all_cells():
        rec = json.loads((tmp_path / "pod2x2" / f"{arch}__{shape}.json").read_text())
        skip = tcfgs.cell_is_skipped(arch, shape)
        assert rec["status"] == ("skipped" if skip else "ok"), rec
        if not skip:
            assert rec["mesh"] == "pod2x2" and rec["n_devices"] == 4
            assert rec["cost_analysis"]["flops"] > 0
    gemma = json.loads((tmp_path / "pod2x2" / "gemma2-9b__train_4k.json").read_text())
    assert gemma["collectives"]["all-gather"]["count"] > 0   # fsdp gathers


def test_cli_plans_one_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    tdry.main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--out", str(out)])
    printed = capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "pod16x16"
    assert "useful_flops_ratio" in printed
