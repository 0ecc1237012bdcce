"""Tests of the benchmark harness on the CPU: cells found by name from
files alone, deterministic traffic, the frozen ledger against the port's,
the weight layout against the port's schema, the plain reference against
the port at a tiny float32 size, the result line's keys, and what a run
loads and refuses."""
import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from benchlib import ledger, tiny, traffic, weights  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    entry = {c["name"]: c for c in SPEC["configs"]}[name]
    return json.loads((ROOT / entry["file"]).read_text())


# ---------------------------------------------------------------------------
# The benchmark's files


def test_every_named_file_exists():
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert (BENCH / "reference" /
                f"{_config(c['name'])['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        mix = traffic.load(BENCH, w["traffic"])
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for mt in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{mt['name']}.py").is_file()


def test_every_cell_reports_what_its_layer_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for mt in SPEC["per_layer"]:
        moved = e2e[mt["moves"]]
        for w in mt["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (
                mt["name"], w)


@pytest.mark.parametrize("name", ["dit-xl-2", "t2i-transformer"])
def test_config_file_is_the_ports_config_uncut(name):
    from repro_torch.configs import get_config
    from benchlib import port
    cfg = _config(name)
    assert cfg["reduced"] == []
    assert port.model_config(cfg["model"]) == get_config(name)


@pytest.mark.parametrize("name", ["dit-xl-2", "t2i-transformer"])
def test_weight_layout_is_the_ports_schema(name):
    from repro_torch.models import dit as dit_mod
    from repro_torch.models.common import tree_map
    from benchlib import port
    m = _config(name)["model"]
    ours = tree_map(lambda leaf: leaf[0], weights.layout(m))
    theirs = tree_map(lambda spec: tuple(spec.shape),
                      dit_mod.dit_schema(port.model_config(m)))
    assert ours == theirs


def test_weights_are_drawn_from_the_seed():
    m = tiny.tiny_config(_config("t2i-transformer"))["model"]
    a = weights.make(m, 2 ** 40 + 3, "cpu", torch.float32)
    b = weights.make(m, 2 ** 40 + 3, "cpu", torch.float32)
    c = weights.make(m, 2 ** 40 + 4, "cpu", torch.float32)
    assert torch.equal(a["blocks"]["lora"]["mlp"]["w_in"]["b"],
                       b["blocks"]["lora"]["mlp"]["w_in"]["b"])
    assert not torch.equal(a["embed"]["w_flex"], c["embed"]["w_flex"])
    for path_leaf in (a["deembed"]["w_flex"], a["blocks"]["ada"]["w"],
                      a["blocks"]["xattn"]["wo"], a["ps_embed"]):
        assert path_leaf.abs().min() >= 0 and path_leaf.abs().sum() > 0


# ---------------------------------------------------------------------------
# Traffic


def test_traffic_is_deterministic_for_a_seed():
    mix = traffic.load(BENCH, "mixed.poisson")
    a = traffic.Stream(mix, 2 ** 33 + 1, seconds=45)
    b = traffic.Stream(mix, 2 ** 33 + 1, seconds=45)
    c = traffic.Stream(mix, 2 ** 33 + 2, seconds=45)
    assert np.array_equal(a.due, b.due)
    assert [a.budget(i) for i in range(50)] == [b.budget(i) for i in range(50)]
    assert [a.label(i) for i in range(50)] == [b.label(i) for i in range(50)]
    # another seed: other labels and priors, the same work
    assert [a.budget(i) for i in range(50)] == [c.budget(i) for i in range(50)]
    assert np.array_equal(a.due, c.due)
    assert [a.label(i) for i in range(50)] != [c.label(i) for i in range(50)]
    pa = traffic.DeviceDraws(5, "priors", (1, 2, 2, 4), "cpu", chunk=4)
    pb = traffic.DeviceDraws(5, "priors", (1, 2, 2, 4), "cpu", chunk=4)
    pc = traffic.DeviceDraws(6, "priors", (1, 2, 2, 4), "cpu", chunk=4)
    assert torch.equal(pa[9], pb[9]) and not torch.equal(pa[9], pa[8])
    assert not torch.equal(pa[9], pc[9])


def test_poisson_gaps_and_the_work_are_the_same_for_every_seed():
    mix = traffic.load(BENCH, "mixed.poisson")
    seconds = SPEC["run_seconds"]
    rate = mix["rate_per_s"]
    runs = [traffic.Stream(mix, s, seconds=seconds) for s in (1, 2 ** 35 + 9)]
    for st in runs:
        assert len(st) == round(rate * seconds) >= 200
        # a Poisson process's gaps: mean 1/rate (the quantiles' truncated
        # tail reads a little under), spread as the exponential's
        assert 0.98 < np.mean(st.gaps) * rate <= 1.0
        assert 0.9 < np.std(st.gaps) * rate < 1.0
        assert st.due[0] == 0.0 and np.all(np.diff(st.due) > 0)
        counts = {b: sum(st.budget(i) == b for i in range(len(st)))
                  for b in mix["budgets"]}
        assert max(counts.values()) - min(counts.values()) <= 1
    # every seed's arrivals and sizes are the same
    assert np.array_equal(runs[0].due, runs[1].due)
    assert [runs[0].budget(i) for i in range(30)] == \
        [runs[1].budget(i) for i in range(30)]


# ---------------------------------------------------------------------------
# The frozen ledger against the port's


@pytest.mark.parametrize("name", ["dit-xl-2", "t2i-transformer"])
def test_frozen_flops_equal_the_ports(name):
    from repro_torch.core.scheduler import dit_nfe_flops
    from repro_torch.pipeline.plan import SamplingPlan
    from benchlib import port
    m = _config(name)["model"]
    cfg = port.model_config(m)
    for mode in range(len(ledger.patch_sizes(m))):
        assert ledger.nfe_flops(m, mode) == dit_nfe_flops(cfg, mode)
    for w in SPEC["workloads"]:
        if w["config"] != name:
            continue
        mix = traffic.load(BENCH, w["traffic"])
        p = mix["plan"]
        guided = p["guidance_scale"] != 0.0
        for b in mix.get("budgets", [mix.get("budget")]):
            b = p.get("budget", b)
            plan = SamplingPlan(T=p["T"], budget=b, solver=p["solver"],
                                guidance_scale=p["guidance_scale"])
            phases = ledger.resolve_schedule(m, p["T"], b, guided)
            assert phases == plan.resolve_schedule(cfg).phases
            assert ledger.schedule_flops(m, phases, guided) == plan.flops(cfg)
            assert math.isclose(ledger.relative_compute(m, phases, guided),
                                plan.relative_compute(cfg), rel_tol=1e-12)


def test_the_cells_schedules():
    dit = _config("dit-xl-2")["model"]
    weak = {b: ledger.resolve_schedule(dit, 50, b, True)[0][1]
            for b in (0.6, 0.8, 1.0)}
    assert weak == {0.6: 27, 0.8: 14, 1.0: 0}
    t2i = _config("t2i-transformer")["model"]
    phases = ledger.resolve_schedule(t2i, 28, 0.6, False)
    assert phases == ((1, 15), (0, 13))
    assert round(ledger.relative_compute(t2i, phases, False), 3) == 0.577


def test_flash_work_counts_pairs_inside_segments():
    ops, nbytes = ledger.flash_work([(256, 2), (64, 4)], 1152)
    assert ops == 4 * 1152 * (2 * 256 ** 2 + 4 * 64 ** 2)
    assert nbytes == 4 * 1152 * 2 * (2 * 256 + 4 * 64)


# ---------------------------------------------------------------------------
# Whole runs at the tiny size on the CPU


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_tiny_run_agrees_with_the_reference_and_has_the_result_keys(
        workload):
    line = tiny.cpu_run(workload)
    assert set(line) == LINE_KEYS
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] > 0
    # float32 on both sides: the reference's equations are the port's
    assert line["check"]["x0_rel_err"]["value"] < 1e-5
    names = {m["name"] for m in SPEC["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == names
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])


def test_traced_run_reports_its_layer_metrics_and_a_breakdown():
    line = tiny.cpu_run("dit-xl-2.mixed.backlog", trace=True)
    assert set(line) == LINE_KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # no device on the CPU: the host counters and the model's FLOPs read
    assert line["metrics"]["graphs.built_in_window"]["value"] == 0.0
    assert 0 < line["metrics"]["engine.packing_efficiency"]["value"] <= 1


def test_a_new_config_mix_metric_and_cell_are_found_from_files_alone(
        tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = _config("dit-xl-2")
    cfg["name"] = "dit-b-2"
    cfg["model"].update(name="dit-b-2", num_layers=12, d_model=768,
                        d_ff=3072)
    cfg["model"]["attn"].update(num_heads=12, num_kv_heads=12, head_dim=64)
    (bench / "configs" / "dit-b-2.json").write_text(json.dumps(cfg))
    mix = traffic.load(BENCH, "mixed.backlog")
    mix["budgets"] = [0.8, 1.0]
    (bench / "traffic" / "pair.backlog.json").write_text(json.dumps(mix))
    (bench / "metrics" / "engine.requests_a_step.py").write_text(
        "def read(obs, ctx):\n"
        "    s = obs.get('steps')\n"
        "    return sum(x['n'] for x in s) / len(s) if s else None\n")
    (bench / "limits" / "dit-b-2.pair.backlog.json").write_text(
        json.dumps({"limits": {"x0_rel_err": 0.025, "failed": 0}}))
    spec["configs"].append({"name": "dit-b-2", "source": "x",
                            "file": "bench/configs/dit-b-2.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dit-b-2.pair.backlog",
                              "config": "dit-b-2", "traffic": "pair.backlog",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "engine.requests_a_step",
                              "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "engine",
                              "moves": "img_per_s",
                              "workloads": ["dit-b-2.pair.backlog"]})
    spec["end_to_end"][0]["workloads"].append("dit-b-2.pair.backlog")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    line = tiny.cpu_run("dit-b-2.pair.backlog", bench=bench, spec=spec,
                        trace=True)
    assert line["correct"] is True
    assert line["metrics"]["engine.requests_a_step"]["value"] > 0


# ---------------------------------------------------------------------------
# What a run loads and refuses


def _env_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_a_run_loads_no_jax_and_no_reference_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchlib import tiny\n"
        "line = tiny.cpu_run('t2i-transformer.b0.6.batch4', trace=True)\n"
        "line = tiny.cpu_run('dit-xl-2.mixed.poisson')\n"
        "run = tiny.load_run()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env_without_jax(), timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = [eval(x) for x in out.stdout.strip().splitlines()[-2:]]
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "typing",
                                           "numpy", "torch"}, (path, n)


def test_without_a_card_a_run_prints_no_result_and_fails():
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", w, "--seed",
         str(2 ** 32 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=_env_without_jax(), timeout=120,
        cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, 'bench')\n"
            "from benchlib import tiny\n"
            "tiny.cpu_run(%r)\n" % SPEC["workloads"][0]["name"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
