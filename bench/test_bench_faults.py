"""The output check must come out as not correct when the timed path is
broken: each fault a cell can have is planted in the program underneath
a whole run at the tiny size on the CPU (where the program runs eagerly,
so a patched function is what runs), and the control, the reference at
fp8 in the program's place, must fail the cell's limit: at the tiny size
here, at the cell's own size on the card (``gpu``)."""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from benchlib import compare, tiny  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
ENGINE = "dit-xl-2.mixed.backlog"
PIPELINE = "t2i-transformer.b0.6.batch4"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unchanged(mod, name):
    """A solver step that returns its state unchanged."""
    if name == "ddim_step":
        return lambda sched, x_t, *a, **k: x_t
    return lambda v_fn, x, taus: x


def _half_left_out(mod, name):
    """Half of the batch left out of the step: its rows take the mean
    over the rest."""
    orig = getattr(mod, name)

    def step(*a, **k):
        out = orig(*a, **k).clone()
        h = out.shape[0] // 2
        if h:
            out[h:] = out[:h].mean(dim=0, keepdim=True)
        return out
    return step


def _answer_altered(mod, name):
    """The finished sample altered where it is produced: the last solver
    step's output scaled by 1.1."""
    orig = getattr(mod, name)
    if name == "ddim_step":
        def step(sched, x_t, eps, t, t_prev, *a, **k):
            out = orig(sched, x_t, eps, t, t_prev, *a, **k)
            last = (t_prev < 0).reshape((-1,) + (1,) * (out.ndim - 1))
            return torch.where(last, out * 1.1, out)
        return step

    def sample(*a, **k):
        return orig(*a, **k) * 1.1
    return sample


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


def _target(workload, fault):
    from repro_torch.diffusion import flow, schedule
    if "t2i" not in workload:
        return schedule, "ddim_step"
    return flow, ("sample_flow_phased" if fault == "answer_altered"
                  else "euler_phase")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", [ENGINE, "dit-xl-2.mixed.poisson",
                                      PIPELINE])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    mod, name = _target(workload, fault)
    monkeypatch.setattr(mod, name, FAULTS[fault](mod, name))
    # open loop: arrivals fast enough that packs hold several requests
    line = tiny.cpu_run(workload, seconds=0.6,
                        rate=60.0 if "poisson" in workload else None)
    assert line["attempted"] > 0
    assert line["correct"] is False, line["check"]
    assert line["check"]["x0_rel_err"]["value"] > \
        line["check"]["x0_rel_err"]["limit"]


@pytest.mark.parametrize("workload", [ENGINE, PIPELINE])
def test_the_fp8_control_fails_the_limit_at_the_tiny_size(workload):
    ctx = tiny.tiny_ctx(workload)
    ctx.mix["plan"]["T"] = {ENGINE: 50, PIPELINE: 28}[workload]
    run = tiny.load_run()
    driver = run.load_module(BENCH / "drivers" / f"{ctx.mix['driver']}.py",
                             "bench_test_driver_" + ctx.mix["driver"])
    v = driver.control_reading(ctx, "fp8")
    ok, _ = compare.judge({"x0_rel_err": v, "failed": 0.0}, ctx.limits)
    assert not ok, v


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_fp8_control_fails_the_limit_on_the_card(workload, card):
    run = tiny.load_run()
    spec = run.load_spec()
    ctx = run.make_ctx(spec, workload, 2 ** 32 + 77, SPEC["run_seconds"],
                       False, card)
    driver = run.load_module(BENCH / "drivers" / f"{ctx.mix['driver']}.py",
                             "bench_test_driver_" + ctx.mix["driver"])
    v = driver.control_reading(ctx, "fp8")
    assert v > ctx.limits["x0_rel_err"], v
