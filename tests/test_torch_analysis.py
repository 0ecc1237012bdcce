"""The port's source analysis (``repro_torch/analysis``) against the JAX
package's: each ported rule, handed the same fixture text with only the
import root changed (``jax`` → ``torch``, ``repro.`` → ``repro_torch.``,
``src/repro/`` → ``src/repro_torch/``), gives the reference rule's
findings as (rule, severity, line, symbol). Then the port's own: the
torch reads-back the rules add (``.cpu()``, ``.tolist()``, ``.numpy()``,
``torch.*``), the cache-key rule on the port's pipeline (clean, and
flagging a dropped witness or a packed-step argument outside the key),
suppressions, the baseline round trip and its justifications, the rule
catalog, and the strict CLI on ``src/repro_torch``.
"""
import ast
import dataclasses
import json
import re
import textwrap
from pathlib import Path

import pytest
from torch_threads import one_torch_thread  # noqa: F401

from repro.analysis import rules_cachekey as jrc
from repro.analysis import rules_fleet as jfleet
from repro.analysis import rules_mask as jmask
from repro.analysis import rules_resilience as jres
from repro.analysis import rules_telemetry as jtel
from repro_torch.analysis import engine
from repro_torch.analysis import rules_cachekey as trc
from repro_torch.analysis import rules_fleet as tfleet
from repro_torch.analysis import rules_mask as tmask
from repro_torch.analysis import rules_resilience as tres
from repro_torch.analysis import rules_telemetry as ttel
from repro_torch.analysis.__main__ import main

PORT_SRC = engine.REPO_ROOT / "src" / "repro_torch"


def to_port(text: str) -> str:
    """The fixture with its import root changed."""
    text = re.sub(r"\bjax\b", "torch", text)
    return text.replace("src/repro/", "src/repro_torch/").replace(
        "repro.", "repro_torch.")


def found(findings):
    return sorted((f.rule, f.severity, f.line, f.symbol) for f in findings)


# (rule pair, path in the reference's tree, fixture text)
SOURCE_CASES = [
    # telemetry: taps
    ("telemetry", "src/repro/telemetry/taps.py",
     "import jax\ndef tap(x):\n    jax.debug.print('{}', x)\n"),
    ("telemetry", "src/repro/telemetry/taps.py",
     "from jax import pure_callback\ndef t(x):\n    return pure_callback(f, s, x)\n"),
    ("telemetry", "src/repro/telemetry/taps.py",
     "import numpy as np\nclass TapAggregator:\n    def add(self, s):\n"
     "        self.v = np.asarray(s.eps)\n"),
    ("telemetry", "src/repro/telemetry/taps.py",
     "import numpy as np\nclass TapAggregator:\n    def aggregate(self):\n"
     "        return float(np.asarray(self.v).mean())\n"),
    ("telemetry", "src/repro/telemetry/taps.py",
     "def tap(x):\n    return x.item() + jax.device_get(x)\n"),
    ("telemetry", "src/repro/pipeline/packed.py",
     "import jax\njax.debug.print('x')\n"),
    # telemetry: attribution
    ("telemetry", "src/repro/telemetry/attribution.py", "import numpy as np\n"),
    ("telemetry", "src/repro/telemetry/attribution.py",
     "from jax import numpy as jnp\n"),
    ("telemetry", "src/repro/telemetry/attribution.py", "import jaxlib\n"),
    ("telemetry", "src/repro/telemetry/attribution.py",
     "def f(x):\n    return np.sum(x)\n"),
    ("telemetry", "src/repro/telemetry/attribution.py",
     "def f(x):\n    return x.block_until_ready()\n"),
    ("telemetry", "src/repro/telemetry/attribution.py",
     "def f(x):\n    return x.item()\n"),
    ("telemetry", "src/repro/telemetry/attribution.py",
     "import dataclasses\ndef exact_shares(total, weights):\n"
     "    s = float(sum(weights))\n    return [int(total * w / s) for w in weights]\n"),
    # fleet
    ("fleet", "src/repro/fleet/router.py",
     "import numpy as np\ndef score(xs):\n    return float(np.mean(xs).item())\n"),
    ("fleet", "src/repro/fleet/health.py",
     "import jax.numpy as jnp\nfrom jax import device_get\n"
     "def w(x):\n    return jax.device_get(jnp.sum(x))\n"),
    ("fleet", "src/repro/fleet/membership.py",
     "import heapq\ndef beat(seen, now):\n    return min(seen.values()) if seen else now\n"),
    ("fleet", "src/repro/fleet/replica.py", "import numpy as np\nnp.zeros(3).item()\n"),
    # resilience
    ("res_pure", "src/repro/resilience/faults.py",
     "import numpy as np\ndef due(now):\n    return float(np.min(now).item())\n"),
    ("res_pure", "src/repro/resilience/journal.py",
     "import json\ndef line(rec):\n    return json.dumps(rec)\n"),
    ("res_guard", "src/repro/serving/scheduler.py",
     "class E:\n"
     "    def bad(self):\n"
     "        return self._faults.take_poison(1)\n"
     "    def guarded(self):\n"
     "        if self._faults is not None:\n"
     "            return self._faults.take_poison(1)\n"
     "    def short_circuit(self):\n"
     "        if self._faults is not None and self._faults.take_poison(1):\n"
     "            return 1\n"
     "    def early_return(self):\n"
     "        if self._faults is None:\n"
     "            return None\n"
     "        return self._faults.take_poison(1)\n"),
    ("res_guard", "src/repro/fleet/fleet.py",
     "class F:\n"
     "    def tick(self, now):\n"
     "        for ev in self._injector.due(now):\n"
     "            pass\n"
     "        with self._injector.window():\n"
     "            pass\n"
     "        while self.faults.pending():\n"
     "            if self._injector is not None:\n"
     "                self._injector.fire()\n"
     "        inj = self._injector\n"
     "        if inj is None:\n"
     "            return\n"
     "        inj.due(now)\n"),
]

RULES = {"telemetry": (jtel.TelemetryRule, ttel.TelemetryRule),
         "fleet": (jfleet.FleetHostPureRule, tfleet.FleetHostPureRule),
         "res_pure": (jres.ResilienceHostPureRule, tres.ResilienceHostPureRule),
         "res_guard": (jres.ResilienceArmedGuardRule, tres.ResilienceArmedGuardRule)}


@pytest.mark.parametrize("case", range(len(SOURCE_CASES)))
def test_source_rules_match_reference(case):
    kind, path, text = SOURCE_CASES[case]
    jrule, trule = RULES[kind]
    want = jrule().check(path, ast.parse(text), text)
    port_text = to_port(text)
    got = trule().check(to_port(path), ast.parse(port_text), port_text)
    assert found(got) == found(want)
    assert {f.path for f in got} <= {to_port(path)}


MASK_CASES = [
    "def segment_allowed(q_seg, k_seg):\n    return q_seg == k_seg\n",
    "import jax.numpy as jnp\ndef my_mask(q_seg, k_seg):\n"
    "    return jnp.where(q_seg[:, None] == k_seg[None, :], 0.0, -1e9)\n",
    "from repro.kernels.attention import mask\ndef my_mask(q_seg, k_seg):\n"
    "    return mask.segment_allowed(q_seg, k_seg)\n",
    "def attention_block_map(a, b):\n    return a != b\n"
    "def f(seg_q, seg_k):\n    return seg_q.seg != seg_k\n",
]


@pytest.mark.parametrize("case", range(len(MASK_CASES)))
def test_mask_rule_matches_reference(case):
    text = MASK_CASES[case]
    jfiles = {"src/repro/models/other.py": (ast.parse(text), text),
              jmask.CANONICAL: (ast.parse(text), text)}
    pt = to_port(text)
    tfiles = {"src/repro_torch/models/other.py": (ast.parse(pt), pt),
              tmask.CANONICAL: (ast.parse(pt), pt)}
    assert found(tmask.MaskParityRule().check_repo(tfiles)) == \
        found(jmask.MaskParityRule().check_repo(jfiles))


def test_mask_rule_requires_the_backends_to_import_the_mask():
    bare = "def attend(q, k):\n    return q @ k\n"
    importer = "from repro.kernels.attention import mask\n"
    for jpath, tpath in zip(jmask.REQUIRED_IMPORTERS[:3], tmask.REQUIRED_IMPORTERS[:3]):
        for text in (bare, importer):
            want = jmask.MaskParityRule().check_repo(
                {jpath: (ast.parse(text), text)})
            pt = to_port(text)
            got = tmask.MaskParityRule().check_repo({tpath: (ast.parse(pt), pt)})
            assert found(got) == found(want)
    # the port's backends: dense, DiT, the kernel's tile map and plain
    # version, the distributed loops; all import the mask today
    findings = engine.lint_paths([PORT_SRC / "models", PORT_SRC / "kernels",
                                  PORT_SRC / "distributed"])
    assert not [f for f in findings if f.rule.startswith("mask-parity")]
    assert tmask.CANONICAL_FNS == jmask.CANONICAL_FNS


@pytest.mark.parametrize("kind,path", [
    ("fleet", "src/repro_torch/fleet/router.py"),
    ("res_pure", "src/repro_torch/resilience/faults.py"),
    ("telemetry", "src/repro_torch/telemetry/attribution.py")])
def test_torch_reads_back_are_flagged(kind, path):
    """What the port adds: torch is a device library, and ``.cpu()``,
    ``.tolist()``, ``.numpy()`` and ``torch.cuda.synchronize()`` read a
    device value back."""
    text = ("import torch\n"
            "def f(x):\n"
            "    a = x.cpu()\n"
            "    b = x.tolist()\n"
            "    c = x.numpy()\n"
            "    torch.cuda.synchronize()\n"
            "    return a, b, c\n")
    got = RULES[kind][1]().check(path, ast.parse(text), text)
    assert sorted(f.line for f in got) == [1, 3, 4, 5, 6]
    assert len({f.rule for f in got}) == 1


def test_tap_sync_outside_sinks_flags_torch_reads():
    text = ("class TapAggregator:\n"
            "    def add(self, s):\n"
            "        self.v = s.eps.cpu()\n"
            "    def aggregate(self):\n"
            "        return s.eps.numpy()\n")
    got = ttel.TelemetryRule().check("src/repro_torch/telemetry/taps.py",
                                     ast.parse(text), text)
    assert found(got) == [("telemetry-tap-host-sync", "error", 3, "add")]


def test_port_control_modules_pass_their_rules():
    findings = engine.lint_paths([PORT_SRC / "fleet", PORT_SRC / "resilience",
                                  PORT_SRC / "serving" / "scheduler.py",
                                  PORT_SRC / "telemetry"])
    new, old = engine.split_baselined(findings, engine.load_baseline())
    assert new == [], [f.render() for f in new]
    assert {f.rule for f in old} <= {"telemetry-tap-host-sync"}


# ---------------------------------------------------------------------------
# Cache keys


def test_check_witnesses_equals_reference():
    cases = [(["a", "b"], {"a": ("wa",)}, ("b",), "key = (wa, other)"),
             (["a"], {"a": ("zzz",)}, (), "key = (wa,)"),
             (["c"], {}, (), "")]
    for fields, wit, data, text in cases:
        assert trc.check_witnesses(fields, wit, data, text, "X") == \
            jrc.check_witnesses(fields, wit, data, text, "X")


def test_keyed_field_sets_pinned_to_the_reference_tables():
    from repro_torch.cache.policy import CacheSpec
    from repro_torch.distributed.partition import ParallelSpec
    from repro_torch.pipeline.packed import PackLayout
    from repro_torch.pipeline.plan import SamplingPlan
    fields = lambda c: {f.name for f in dataclasses.fields(c)}
    assert fields(SamplingPlan) == set(trc.PLAN_WITNESSES) | set(trc.PLAN_DATA_ONLY)
    assert set(trc.PLAN_WITNESSES) == set(jrc.PLAN_WITNESSES)
    assert trc.PLAN_DATA_ONLY == jrc.PLAN_DATA_ONLY
    assert fields(CacheSpec) == set(trc.CACHESPEC_STRUCTURAL) | set(trc.CACHESPEC_DATA_ONLY)
    assert trc.CACHESPEC_DATA_ONLY == jrc.CACHESPEC_DATA_ONLY
    assert fields(ParallelSpec) == {"axis", "attn"}
    assert fields(PackLayout) == {"groups", "guided", "row_capacity"}


def _pipeline_files(edit_pipeline=None, edit_packed=None):
    files = {}
    for rel, edit in ((trc.PIPELINE_PATH, edit_pipeline),
                      (trc.PACKED_PATH, edit_packed)):
        text = (engine.REPO_ROOT / rel).read_text()
        if edit:
            text = edit(text)
        files[rel] = (ast.parse(text), text)
    return files


def test_cachekey_rule_clean_on_the_port():
    assert trc.CacheKeyRule().check_repo(_pipeline_files()) == []


def test_cachekey_rule_flags_a_dropped_witness():
    drop = lambda t: t.replace("plan.guidance_kind, plan.weak_mode",
                               "plan.weak_mode")
    got = trc.CacheKeyRule().check_repo(_pipeline_files(drop))
    assert [(f.rule, f.symbol) for f in got] == \
        [("cachekey-missing", "SamplingPlan.guidance_kind")]


def test_cachekey_rule_flags_a_packed_arg_outside_the_key():
    extra = lambda t: t.replace("                        taps: bool = False) -> Callable:",
                                "                        taps: bool = False,\n"
                                "                        fused: bool = False) -> Callable:")
    got = trc.CacheKeyRule().check_repo(_pipeline_files(edit_packed=extra))
    assert [(f.rule, f.symbol) for f in got] == [("cachekey-missing", "packed.fused")]


# ---------------------------------------------------------------------------
# Engine: suppressions, baseline, catalog, CLI


def _lint_src(tmp_path, rel, src, **kw):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return engine.lint_paths([p], **kw)


def test_inline_suppression_roundtrip(tmp_path):
    src = """
        def score(xs):
            return xs.item()  # repro: ignore[fleet-host-pure]
    """
    assert _lint_src(tmp_path, "fleet/router.py", src) == []
    kept = _lint_src(tmp_path, "fleet/router.py", src, collect_suppressed=True)
    assert {f.rule for f in kept} == {"fleet-host-pure"}
    other = src.replace("fleet-host-pure", "mask-parity")
    assert {f.rule for f in _lint_src(tmp_path, "fleet/router.py", other)} \
        == {"fleet-host-pure"}
    bare = src.replace("[fleet-host-pure]", "")
    assert _lint_src(tmp_path, "fleet/router.py", bare) == []


def test_baseline_roundtrip_and_justification(tmp_path):
    f = engine.Finding("fleet-host-pure", "error", "pkg/mod.py", 12, "msg", "fn")
    entries = engine.baseline_entries([f, f], justification="known")
    assert len(entries) == 1
    new, old = engine.split_baselined([f], entries)
    assert new == [] and old == [f]
    f2 = dataclasses.replace(f, line=99)        # the key is line-free
    assert engine.split_baselined([f2], entries) == ([], [f2])
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": [
        {"rule": "r", "path": "p.py", "symbol": "f"}]}))
    with pytest.raises(ValueError, match="justification"):
        engine.load_baseline(p)


def test_committed_baseline_entries_are_justified_and_live():
    entries = engine.load_baseline()
    live = engine.lint_paths([PORT_SRC])
    keys = {f.baseline_key() for f in live}
    for e in entries:
        assert len(e["justification"]) > 40 and "TODO" not in e["justification"]
        assert e["rule"] in engine.RULE_IDS
        assert f"{e['rule']}:{e['path']}:{e['symbol']}" in keys, e


def test_catalog_lists_the_ported_rules():
    live = engine.lint_paths([PORT_SRC], collect_suppressed=True)
    assert {f.rule for f in live} <= set(engine.RULE_IDS)
    # the trace-safety rules are ported; the jaxpr audit's ids are the
    # graph audit's ``graph-`` ids
    assert {"trace-host-cast", "trace-host-copy", "hot-host-sync",
            "graph-fingerprint-drift", "graph-uncaptured-runner"} \
        <= set(engine.RULE_IDS)
    assert not any(r.startswith("jaxpr-") for r in engine.RULE_IDS)
    assert engine.REPO_ROOT == Path(__file__).resolve().parents[1]
    assert engine.BASELINE_PATH == PORT_SRC / "analysis" / "baseline.json"


def test_strict_cli_clean_on_the_port(tmp_path, capsys):
    assert main(["--strict", str(PORT_SRC)]) == 0
    assert "0 new finding(s), 0 error(s)" in capsys.readouterr().out
    bad = tmp_path / "fleet" / "router.py"
    bad.parent.mkdir()
    bad.write_text("import torch\n")
    # the graph audit ran above; the bad file is a source-rule case
    assert main(["--strict", "--no-graphs", str(bad)]) == 1
    assert main(["--no-graphs", str(bad)]) == 0
    capsys.readouterr()
    assert main(["--json", "--no-graphs", str(bad)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is False
    assert [f["rule"] for f in rep["new"]] == ["fleet-host-pure"]
