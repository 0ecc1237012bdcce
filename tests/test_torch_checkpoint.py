"""The port's checkpointer and training runtime against the JAX package:
the on-disk layout is the reference's, so checkpoints cross packages in
both directions (bfloat16 leaves as the reference writes them, 2-byte
void ``.npy`` elements with ``"bfloat16"`` in the manifest), plus the
port's counterparts of ``tests/test_checkpoint_ft.py`` (round trip,
retention, uncommitted directories, heartbeats, recovery, stragglers,
and restore with ``shardings=`` on a one-rank mesh; the elastic restore
across ranks is in ``test_torch_sharded_train.py``).

Every comparison here is exact: bit for bit, or byte for byte on disk.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstr
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 TrainingSupervisor,
                                                 run_with_recovery)
from repro_torch.runtime.straggler import (StragglerDetector,
                                           backup_request_schedule,
                                           rebalance_shards)


def _np_tree(seed=0):
    """A nested tree of float32 values (the leaves ``w`` and ``b`` become
    bfloat16 in both packages, by the same rounding), int32 ids and a
    0-d int32 step."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(4, 8)).astype(np.float32),
                       "blocks": {"b": rng.normal(size=(2, 6)).astype(np.float32),
                                  "ids": np.arange(5, dtype=np.int32)}},
            "opt": {"m": rng.normal(size=(4, 8)).astype(np.float32),
                    "step": np.int32(7)}}


def _torch_tree(tree, bf16=("w", "b")):
    """The numpy tree as tensors, the named leaves in bfloat16."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch_tree(v, bf16)
        else:
            t = torch.from_numpy(np.array(v))
            out[k] = t.to(torch.bfloat16) if k in bf16 else t
    return out


def _jax_tree(tree, bf16=("w", "b")):
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(v, jnp.bfloat16
                                    if path[-1].key in bf16 else v.dtype), tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, prefix + (k,)).items()}
    return {prefix: tree}


def _bits(t):
    """A leaf's raw bytes (bfloat16 tensors by their int16 view)."""
    if torch.is_tensor(t):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def _assert_bitwise(got, want):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        assert tuple(fg[k].shape) == tuple(fw[k].shape), k
        assert _bits(fg[k]) == _bits(fw[k]), k


# ---------------------------------------------------------------------------
# The port's own round trip


@pytest.mark.parametrize("async_save", [False, True])
def test_roundtrip_is_bitwise_for_f32_and_bf16(tmp_path, async_save):
    ck = Checkpointer(tmp_path, async_save=async_save)
    t = _torch_tree(_np_tree())
    ck.save(10, t, extra={"note": "hi"})
    ck.wait()
    restored, extra = ck.restore(device="cpu")
    assert extra == {"note": "hi"}
    _assert_bitwise(restored, t)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert restored["opt"]["step"].shape == ()
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["params__w"] == {"shape": [4, 8],
                                               "dtype": "bfloat16"}
    assert manifest["leaves"]["opt__step"] == {"shape": [], "dtype": "int32"}


def test_async_save_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        ck.save(s, _torch_tree(_np_tree(s)))
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_save_copies_before_returning(tmp_path):
    """An async save holds the values the tree had when save() was called."""
    ck = Checkpointer(tmp_path, async_save=True)
    t = {"w": torch.zeros(64, 64)}
    ck.save(1, t)
    t["w"].add_(1.0)
    ck.wait()
    restored, _ = ck.restore(device="cpu")
    assert not restored["w"].any()


def test_restore_ignores_uncommitted(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(5, _torch_tree(_np_tree()))
    bad = tmp_path / "step_00000009"     # a crashed save
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step() == 5
    assert ck.all_steps() == [5]
    tree, _ = ck.restore(device="cpu")
    assert int(tree["opt"]["step"]) == 7


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path).restore(device="cpu")


def test_elastic_restore_raises_naming_the_slice(tmp_path):
    """Once a raise naming the distributed slice, now the behaviour
    (``tests/test_checkpoint_ft.py::test_elastic_restore_reshards``):
    restored with ``shardings=`` onto a (1 x 1) mesh of a one-rank group,
    every leaf named there is placed (``R, R``), bit for bit, and the
    leaves not named stay plain tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime import sharding as tshard

    ck = Checkpointer(tmp_path / "ck", async_save=False)
    want = _torch_tree(_np_tree())
    ck.save(7, want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = {"params": {"w": tshard.named(mesh, (None, None)),
                         "blocks": {"b": tshard.named(mesh, ("data", "model")),
                                    "ids": tshard.named(mesh, (None,))}}}
        got, _ = ck.restore(shardings=sh, device="cpu")
        for leaf in (got["params"]["w"], got["params"]["blocks"]["b"]):
            assert isinstance(leaf, DTensor) and leaf.device_mesh is mesh
        assert [str(p) for p in got["params"]["w"].placements] == ["R", "R"]
        assert [str(p) for p in got["params"]["blocks"]["b"].placements] \
            == ["S(0)", "S(1)"]
        assert not isinstance(got["opt"]["m"], DTensor)
        local = {k: (v.to_local() if isinstance(v, DTensor) else v)
                 for k, v in _flat(got).items()}
        _assert_bitwise(local, _flat(want))
    finally:
        dist.destroy_process_group()


def test_restore_defaults_to_cuda(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, {"w": torch.zeros(2)})
    if torch.cuda.is_available():
        assert ck.restore()[0]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.restore()


# ---------------------------------------------------------------------------
# Across packages


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Written by the JAX package (bfloat16 and float32 leaves, an int32
    step), restored by the port: the same values, bit for bit."""
    np_tree = _np_tree(1)
    JCheckpointer(tmp_path, async_save=False).save(3, _jax_tree(np_tree),
                                                   extra={"from": "jax"})
    restored, extra = Checkpointer(tmp_path).restore(device="cpu")
    assert extra == {"from": "jax"}
    _assert_bitwise(restored, _torch_tree(np_tree))
    # the reference's own restore hands the bfloat16 bits back as |V2
    jt, _ = JCheckpointer(tmp_path).restore()
    assert jt["params"]["w"].dtype == np.dtype("V2")


def test_port_checkpoint_loads_in_the_reference_byte_for_byte(tmp_path):
    np_tree = _np_tree(2)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    Checkpointer(tmp_path / "port", async_save=False).save(
        4, _torch_tree(np_tree), extra={"k": 1})
    JCheckpointer(tmp_path / "jax", async_save=False).save(
        4, _jax_tree(np_tree), extra={"k": 1})
    got, extra = JCheckpointer(tmp_path / "port").restore()
    want, _ = JCheckpointer(tmp_path / "jax").restore()
    assert extra == {"k": 1}
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
        assert fg[k].tobytes() == fw[k].tobytes(), k
    # and the files themselves are the reference's, byte for byte
    pd, jd = tmp_path / "port" / "step_00000004", tmp_path / "jax" / "step_00000004"
    names = sorted(p.name for p in jd.glob("*.npy"))
    assert names == sorted(p.name for p in pd.glob("*.npy"))
    for n in names:
        assert (pd / n).read_bytes() == (jd / n).read_bytes(), n
    assert json.loads((pd / "manifest.json").read_text()) == \
        json.loads((jd / "manifest.json").read_text())


# ---------------------------------------------------------------------------
# Fault tolerance and stragglers (the port's copies)


def test_heartbeat_detection():
    clock = {"t": 0.0}
    hb = HeartbeatMonitor(4, timeout_s=10, clock=lambda: clock["t"])
    clock["t"] = 5.0
    hb.heartbeat(0)
    hb.heartbeat(1)
    clock["t"] = 12.0
    dead = hb.check()
    assert set(dead) == {2, 3}
    assert hb.alive_count == 2
    hb.heartbeat(2)
    assert hb.workers[2].alive and hb.workers[2].incarnation == 1
    hb.heartbeat(0, at=1.0)          # a stale beat never moves the stamp back
    assert hb.workers[0].last_heartbeat == 5.0


def test_run_with_recovery_restores_and_completes(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False, device="cpu")
    hb = HeartbeatMonitor(4, timeout_s=1e9)
    sup = TrainingSupervisor(ck, hb, checkpoint_every=5,
                             rescale_plan=lambda n: (n, 1))
    killed = {"done": False}

    def fault_hook(step):
        if step == 7 and not killed["done"]:
            killed["done"] = True
            return [3]
        return None

    def train_fn(step, state):
        return {"x": state["x"] + 1.0}

    state, events = run_with_recovery(train_fn, {"x": torch.zeros(())}, 12,
                                      sup, fault_hook)
    kinds = [e.kind for e in events]
    assert "failure" in kinds and "restart" in kinds and "rescale" in kinds
    # final state reflects 12 *effective* steps (replay from step 5)
    assert float(state["x"]) == 12.0


def test_straggler_detection_and_rebalance():
    sd = StragglerDetector(4, threshold=2.0)
    for step in range(5):
        for w, ms in enumerate([100, 110, 95, 400]):
            sd.record(w, ms)
    rep = sd.report(5)
    assert rep.stragglers == [3]
    shards = rebalance_shards(16, np.asarray([100, 110, 95, 400.0]))
    assert sum(shards) == 16
    assert shards[3] == min(shards)     # slowest gets fewest
    assert shards[2] == max(shards)     # fastest gets most


@pytest.mark.parametrize("times", [[100, 110, 95, 400.0], [10, 10, 10, 10.0],
                                   [1, 2, 3, 4, 50, 60, 70.0]])
def test_runtime_copies_match_the_reference(times):
    assert rebalance_shards(16, np.asarray(times)) == \
        jstr.rebalance_shards(16, np.asarray(times))
    assert backup_request_schedule(times, 90.0) == \
        jstr.backup_request_schedule(times, 90.0)
    sd, jsd = StragglerDetector(len(times)), jstr.StragglerDetector(len(times))
    for _ in range(3):
        for w, ms in enumerate(times):
            sd.record(w, ms)
            jsd.record(w, ms)
    assert dataclasses.astuple(sd.report(3)) == dataclasses.astuple(jsd.report(3))
    clock = {"t": 0.0}
    hb = HeartbeatMonitor(len(times), 50.0, clock=lambda: clock["t"])
    jhb = jft.HeartbeatMonitor(len(times), 50.0, clock=lambda: clock["t"])
    for i, ms in enumerate(times):
        clock["t"] = ms
        hb.heartbeat(i)
        jhb.heartbeat(i)
    clock["t"] = 120.0
    assert hb.check() == jhb.check()
