"""The fleet over sequence-parallel rank groups (``launch/mesh.RankGroup``,
``fleet/groups.RankGroupPipeline``, ``launch/serve.py --mesh DATAxSEQ
--replicas N``) against the JAX package's fixed-slot fleet, on CPU
process groups over Gloo.

The reference runs ``Fleet(engine_kind="fixed", seq_parallel=2)`` on one
device (its fake-device meshes do not run on this jax); the port runs the
same fleet over two groups of 2 rank processes (Ulysses at 2 of 4 heads,
one torch thread a rank), the reference's weights handed to every rank as
numpy and its priors to every request. On the same injected clock the
placement sequence, the request ledger and ``summary()`` equal the
reference's, and every x0 holds within 1e-4 of the reference's. A
scripted kill and a SIGKILLed rank (then the heartbeat timeout, as the
reference's hang) serve every accepted request once, each x0 within 1e-4
of the uninterrupted reference, and leave no process of the killed group
alive; the rejoined replica gets a fresh group. The rank groups start
once per module (a group a test stopped is replaced on the next use).
"""
import dataclasses
import importlib
import math
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import repro.fleet as jfleet
import torch_dist_worker as worker
from repro.core.scheduler import FlexiSchedule as JSchedule
from repro.diffusion import schedule as jschedule
from repro.pipeline import FlexiPipeline as JPipeline
from repro.pipeline import SamplingPlan as JPlan
from repro_torch import fleet as tfleet
from repro_torch.configs import base as tbase
from repro_torch.core.scheduler import FlexiSchedule
from repro_torch.diffusion import schedule as tschedule
from repro_torch.distributed import ParallelSpec
from repro_torch.fleet.groups import RankGroupPipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import SamplingPlan

jflex = importlib.import_module("repro.core.flexify")

T, TRAIN_T, SEQ, N_REQ, FIRST = 6, 100, 2, 10, 8
E2E_TOL = dict(atol=1e-4, rtol=1e-4)
GROUP_TIMEOUT_S = 120.0
SUMMARY_KEYS = ("replicas", "served", "tokens", "makespan_s", "tokens_per_s",
                "request_dispatches", "affinity_hit_rate", "router",
                "membership", "straggler", "readmit", "hedge_losses",
                "escalation")
LEDGER_FIELDS = ("state", "owner", "home", "placements", "handbacks",
                 "readmits", "hedged", "hedge_owner", "served_by", "done_at",
                 "retries", "escalated")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def port_cfg(jcfg):
    """The JAX package's ModelConfig as the port's (the ranks import no
    JAX, so they get the port's class)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["attn"] = tbase.AttnConfig(**dataclasses.asdict(jcfg.attn))
    kw["dit"] = tbase.DiTConfig(**dataclasses.asdict(jcfg.dit))
    return tbase.ModelConfig(**kw)


def make_plans(port: bool):
    Plan, Sched = (SamplingPlan, FlexiSchedule) if port else (JPlan, JSchedule)
    par = {"parallel": ParallelSpec()} if port else {}
    return {0.6: Plan(T=T, budget=Sched.weak_first(T, 3), solver="ddim",
                      guidance_scale=1.5, **par),
            1.0: Plan(T=T, budget=1.0, solver="ddim", guidance_scale=1.5,
                      **par)}


def ref_x_T(rid: int, shape) -> torch.Tensor:
    """The prior the reference fleet draws for fleet id ``rid``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0xf1ee), rid)
    return torch.from_numpy(np.array(jax.random.normal(key, (1,) + shape)))


def gone(pid: int) -> bool:
    """No such process (a reaped child)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def wait_exited(group, timeout_s: float = 60.0) -> None:
    """Until every rank of ``group`` has exited (and is reaped)."""
    for p in group._procs:
        p.join(timeout_s)
        assert p.exitcode is not None


@pytest.fixture(scope="module")
def flexi(tiny_dit_cfg, trained_like_dit):
    fp, fcfg = jflex.flexify(trained_like_dit, tiny_dit_cfg, [(1, 4, 4)])
    return fp, fcfg, jax.tree.map(np.asarray, fp), port_cfg(fcfg)


class Pool:
    """The module's rank groups: a pair for the fleets, a stopped one
    replaced on the next use; every group started is closed at the end."""

    def __init__(self, cfg, weights):
        self.cfg, self.weights = cfg, weights
        self.started, self.live = [], []

    def start(self, rid=None, device_ids=None) -> RankGroupPipeline:
        """A fresh group (also the fleets' ``pipe_factory``)."""
        h = RankGroupPipeline(self.cfg, tschedule.linear_schedule(TRAIN_T),
                              self.weights, SEQ, device="cpu",
                              backend="gloo", timeout_s=GROUP_TIMEOUT_S,
                              threads=1)
        self.started.append(h)
        return h

    def pair(self) -> list:
        self.live = [h if h.alive() else self.start() for h in self.live]
        self.live += [self.start() for _ in range(2 - len(self.live))]
        for h in self.live:
            h.wait_ready()
        return list(self.live)

    def adopt(self, fleet) -> None:
        """The fleet's groups (a rejoined one included) serve next."""
        self.live = [fleet.replicas[i].engine.pipe for i in (0, 1)]


@pytest.fixture(scope="module")
def pool(flexi):
    p = Pool(flexi[3], flexi[2])
    yield p
    for h in p.started:
        h.close()
    assert all(gone(pid) for h in p.started for pid in h.group.pids)


class Side:
    """One package's fixed-slot fleet of 2 replicas, driven by the same
    scenario code: the port's over the pool's rank groups, its requests
    given the reference's priors."""

    def __init__(self, port: bool, pipe=None, pool=None):
        self.port, self.pipe, self.pool = port, pipe, pool
        self.plans = make_plans(port)

    def fleet(self, clk, **kw):
        common = dict(engine_kind="fixed", seq_parallel=SEQ, batch_size=2,
                      clock=clk, seconds_per_token=1e-4, **kw)
        if self.port:
            pipes = self.pool.pair()
            f = tfleet.Fleet(pipes[0], self.plans, 2, pipes=pipes,
                             pipe_factory=self.pool.start, **common)
        else:
            f = jfleet.Fleet(self.pipe, self.plans, 2, **common)
        f.placement_log, f.served = [], []
        place = f.router.place

        def logged(req, views, level):
            r = place(req, views, level)
            f.placement_log.append((req.rid, r, level))
            return r

        f.router.place = logged
        return f

    def submit(self, f, lo: int, hi: int) -> None:
        """Fleet ids lo..hi-1: label rid % 10, budgets alternating."""
        for rid in range(lo, hi):
            kw = {}
            if self.port:
                kw["x_T"] = ref_x_T(rid, tuple(self.pool.cfg.dit.latent_shape))
            assert f.submit(rid % 10, [0.6, 1.0][rid % 2], math.inf,
                            **kw) == rid

    def run(self, f) -> None:
        f.served += f.run()


def scenario_spread(side, policy):
    f = side.fleet(FakeClock(), router=policy)
    side.submit(f, 0, N_REQ)
    side.run(f)
    return f


def scenario_killed(side):
    """Kill replica 0 mid-flight (scripted), drain, rejoin it, 2 more."""
    f = side.fleet(FakeClock(), router="affinity")
    side.submit(f, 0, FIRST)
    f.served += f.tick()
    f.first_pipe = f.replicas[0].engine.pipe
    f.orphans = f.kill_replica(0)
    side.run(f)
    f.incarnation = f.rejoin_replica(0)
    side.submit(f, FIRST, N_REQ)
    side.run(f)
    return f


def scenario_lost(side, stop):
    """Replica 0 stops (the reference: ``inject_hang``; the port: one rank
    of its group SIGKILLed), the heartbeat timeout declares it dead, its
    requests are served elsewhere; then it rejoins and 2 more arrive."""
    clk = FakeClock()
    f = side.fleet(clk, router="rr", heartbeat_timeout_s=5.0)
    side.submit(f, 0, FIRST)
    f.served += f.tick()
    f.first_pipe = f.replicas[0].engine.pipe
    stop(f)
    clk.advance(6.0)
    f.served += f.tick()
    f.state_after = f.membership.state(0)
    side.run(f)
    f.incarnation = f.rejoin_replica(0)
    side.submit(f, FIRST, N_REQ)
    side.run(f)
    return f


def sigkill_rank(f) -> None:
    group = f.replicas[0].engine.pipe.group
    os.kill(group.pids[1], signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while group.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not group.alive()


@pytest.fixture(scope="module")
def reference_runs(flexi):
    """Each scenario once on the reference's fleet (lazily)."""
    fp, fcfg = flexi[:2]
    side = Side(False, pipe=JPipeline(fp, fcfg,
                                      jschedule.linear_schedule(TRAIN_T)))
    runs = {"spread-rr": lambda: scenario_spread(side, "rr"),
            "spread-cheapest": lambda: scenario_spread(side, "cheapest"),
            "killed": lambda: scenario_killed(side),
            "lost": lambda: scenario_lost(side, lambda f: f.inject_hang(0))}
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = runs[name]()
        return cache[name]

    return get


def same_fleet(ours, ref):
    """Placements, per-request ledger and summary equal the reference's;
    every x0 within 1e-4 of the reference's; each request served once."""
    assert ours.placement_log == ref.placement_log
    for rid, jr in ref.router.requests.items():
        tr = ours.router.requests[rid]
        for field in LEDGER_FIELDS:
            assert getattr(tr, field) == getattr(jr, field), (rid, field)
    ts, js = ours.summary(), ref.summary()
    for k in SUMMARY_KEYS:
        assert ts[k] == js[k], k
    assert sorted(r.rid for r in ours.served) == list(range(N_REQ))
    assert sorted(ours.results) == sorted(ref.results)
    for rid, jr in ref.results.items():
        tr = ours.results[rid]
        assert (tr.replica, tr.budget_served, tr.done_at, tr.arrival) \
            == (jr.replica, jr.budget_served, jr.done_at, jr.arrival)
        torch.testing.assert_close(tr.x0, torch.from_numpy(np.array(jr.x0)),
                                   **E2E_TOL)


def same_x0(ours, ref):
    for rid, jr in ref.results.items():
        torch.testing.assert_close(ours.results[rid].x0,
                                   torch.from_numpy(np.array(jr.x0)),
                                   **E2E_TOL)


# ---------------------------------------------------------------------------
# RankGroup's life cycle


def test_group_keeps_each_rank_state_across_calls():
    with tmesh.RankGroup(2, device="cpu", threads=1,
                         timeout_s=GROUP_TIMEOUT_S) as g:
        first = g.call(worker.count_calls, 1)
        again = g.call(worker.count_calls, 5)
        assert g.alive()
        assert [r for r, _, _ in first] == [0, 1]
        assert [n for *_, n in first] == [1, 1] and [n for *_, n in again] \
            == [6, 6]
        assert [p for _, p, _ in first] == [p for _, p, _ in again] == g.pids
    assert not g.alive() and all(gone(pid) for pid in g.pids)


def test_group_raising_rank_fails_the_call_with_its_traceback():
    g = tmesh.RankGroup(2, device="cpu", threads=1, timeout_s=GROUP_TIMEOUT_S)
    try:
        g.call(worker.count_calls, 1)
        # a result that does not pickle is the rank's failure, not a loss
        # (every rank fails it; whichever reply is read first is reported)
        with pytest.raises(RuntimeError, match=r"rank \d of 2 failed") \
                as err:
            g.call(worker.unpicklable_result)
        assert not isinstance(err.value, tmesh.RankLost)
        g = tmesh.RankGroup(2, device="cpu", threads=1,
                            timeout_s=GROUP_TIMEOUT_S)
        g.call(worker.count_calls, 1)
        with pytest.raises(RuntimeError, match="planted failure on rank 1") \
                as err:
            g.call(worker.raise_on_rank, 1)
        assert "Traceback" in str(err.value)
        assert not isinstance(err.value, tmesh.RankLost)
        # rank 0 was left in a barrier: the failure stopped the group
        assert not g.alive() and all(gone(pid) for pid in g.pids)
        with pytest.raises(RuntimeError, match="closed"):
            g.call(worker.count_calls, 1)
    finally:
        g.close()


def test_group_reports_a_killed_rank_within_the_timeout():
    """Rank 1 SIGKILLed mid-call while rank 0 waits for it in a barrier:
    the call raises RankLost at once (not at the timeout) and stops the
    whole group."""
    g = tmesh.RankGroup(2, device="cpu", threads=1, timeout_s=GROUP_TIMEOUT_S)
    try:
        g.call(worker.count_calls, 1)
        g.submit(worker.sleep_then_barrier, 1, GROUP_TIMEOUT_S)
        time.sleep(0.2)
        os.kill(g.pids[1], signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(tmesh.RankLost, match="rank 1 of 2 exited"):
            g.collect()
        assert time.monotonic() - t0 < GROUP_TIMEOUT_S / 4
        assert not g.alive() and all(gone(pid) for pid in g.pids)
    finally:
        g.close()


def test_group_rank_that_cannot_start_is_a_failure_not_a_loss(monkeypatch):
    """Ranks whose ``init_process_group`` fails (Gloo pointed at a network
    interface that does not exist) reply their traceback and exit with 0:
    the call raises that traceback, not RankLost, even after every rank
    has exited."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "no-such-if0")
    g = tmesh.RankGroup(2, device="cpu", threads=1, timeout_s=GROUP_TIMEOUT_S)
    monkeypatch.undo()
    try:
        wait_exited(g)
        with pytest.raises(RuntimeError, match=r"rank \d of 2 failed") \
                as err:
            g.call(worker.count_calls, 1)
        assert not isinstance(err.value, tmesh.RankLost)
        assert "init_process_group" in str(err.value)
        assert not g.alive() and all(gone(pid) for pid in g.pids)
    finally:
        g.close()


def test_group_close_leaves_no_process():
    """A group that lost a rank between calls reads not alive; close()
    reaps every rank; run_ranks (a group called once) leaves none."""
    g = tmesh.RankGroup(2, device="cpu", threads=1, timeout_s=GROUP_TIMEOUT_S)
    g.call(worker.count_calls, 1)
    os.kill(g.pids[0], signal.SIGKILL)
    deadline = time.monotonic() + 30.0
    while g.alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not g.alive() and not gone(g.pids[1])
    g.close()
    g.close()                                   # idempotent
    assert all(gone(pid) for pid in g.pids)
    with pytest.raises(RuntimeError, match="closed"):
        g.submit(worker.count_calls, 1)


# ---------------------------------------------------------------------------
# The fleet over two SEQ-2 groups against the reference's fixed-slot fleet


@pytest.mark.parametrize("policy", ["rr", "cheapest"])
def test_group_fleet_matches_reference(pool, reference_runs, policy):
    ours = scenario_spread(Side(True, pool=pool), policy)
    same_fleet(ours, reference_runs(f"spread-{policy}"))
    assert ours.cache_stats()["pipes"] == 2
    assert len({r.replica for r in ours.results.values()}) == 2


def test_group_fleet_scripted_kill(pool, reference_runs):
    """``kill_replica`` mid-flight closes the killed replica's group; its
    requests are served once elsewhere; the rejoined replica serves on a
    fresh group."""
    ours = scenario_killed(Side(True, pool=pool))
    ref = reference_runs("killed")
    same_fleet(ours, ref)
    same_x0(ours, reference_runs("spread-rr"))
    assert ours.orphans == ref.orphans > 0
    old, new = ours.first_pipe, ours.replicas[0].engine.pipe
    assert new is not old and new.alive() and not old.alive()
    assert all(gone(pid) for pid in old.group.pids)
    assert any(r.replica == 0 for r in ours.served if r.rid >= FIRST)
    pool.adopt(ours)


def test_group_fleet_sigkilled_rank(pool, reference_runs):
    """One rank of replica 0's group SIGKILLed: the replica stops beating,
    the heartbeat timeout declares it dead (as the reference's hang), its
    accepted requests are served once elsewhere, none twice."""
    ours = scenario_lost(Side(True, pool=pool), sigkill_rank)
    ref = reference_runs("lost")
    same_fleet(ours, ref)
    same_x0(ours, reference_runs("spread-rr"))
    assert ours.state_after == ref.state_after == "dead"
    assert ours.summary()["readmit"]["count"] > 0
    old = ours.first_pipe
    assert all(gone(pid) for pid in old.group.pids)
    assert ours.replicas[0].engine.pipe.alive()
    pool.adopt(ours)


def test_group_fleet_rejoin_whose_ranks_cannot_start_fails_loudly(
        pool, monkeypatch):
    """A rejoined replica's fresh group whose ranks fail
    ``init_process_group`` (Gloo is pointed at a network interface that
    does not exist): the fleet raises the rank's traceback, a failure and
    not a replica that stops beating, and leaves no process of it."""
    side = Side(True, pool=pool)
    f = side.fleet(FakeClock(), router="rr")
    f.kill_replica(0)
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "no-such-if0")
    f.rejoin_replica(0)               # the ranks spawn with this setting
    monkeypatch.undo()
    fresh = f.replicas[0].engine.pipe
    wait_exited(fresh.group)          # each replied its failure, then left
    side.submit(f, 0, 4)
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed") as err:
        f.run()
    assert not isinstance(err.value, tmesh.RankLost)
    assert "init_process_group" in str(err.value)
    assert not fresh.alive() and all(gone(pid) for pid in fresh.group.pids)
    f.close()


# ---------------------------------------------------------------------------
# launch/serve.py --mesh DATAxSEQ --replicas N


def test_serve_cli_mesh_fleet_on_cpu(capsys):
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--mesh", "2x2",
                     "--replicas", "2", "--device", "cpu", "--requests", "4",
                     "--T", "4"])
    out = capsys.readouterr().out
    assert "[mesh] 2 replica(s) x seq=2: slices [[0, 1], [2, 3]]" in out
    assert "[mesh] 4 ranks in 2 groups (gloo, cpu)" in out
    assert "[fleet] served 4 requests over 2 replicas" in out
    assert "pipes=2" in out and m["served"] == 4.0


def test_serve_cli_mesh_fleet_refuses_data_unequal_replicas(capsys):
    with pytest.raises(SystemExit, match="DATA=3 must equal --replicas 2"):
        tserve.main(["--arch", "dit-xl-2", "--smoke", "--mesh", "3x2",
                     "--replicas", "2", "--device", "cpu"])
    assert "[mesh]" not in capsys.readouterr().out     # before any rank


def test_serve_cli_mesh_fleet_seq1_packs_a_pipeline_each(capsys):
    m = tserve.main(["--arch", "dit-xl-2", "--smoke", "--mesh", "2x1",
                     "--replicas", "2", "--device", "cpu", "--requests", "4",
                     "--T", "4"])
    out = capsys.readouterr().out
    assert "[mesh] 2 replica(s) x seq=1: slices [[0], [1]]" in out
    assert "[fleet] served 4 requests over 2 replicas" in out
    assert "pipes=2" in out and m["served"] == 4.0
