"""Source lint engine of the port: rule registry, suppressions,
baseline — the port of ``repro.analysis.engine``, which imports no JAX;
the port keeps its own copy.

Vocabulary:

* a **source rule** checks one file's AST (``check(path, tree, text)``);
* a **repo rule** checks cross-file properties (``check_repo(files)``) —
  the cache-key and mask-parity rules live here;
* findings carry a ``severity`` (``error`` fails ``--strict``,
  ``warning`` never does) and a stable :meth:`Finding.baseline_key`
  ``rule:path:symbol`` that survives line drift, so the committed
  baseline does not rot on unrelated edits;
* ``# repro: ignore[rule-a,rule-b]`` (or bare ``# repro: ignore``) on
  the offending line suppresses findings there — for *justified*
  exceptions; the baseline is for *grandfathered* ones.

Two modules reason about the port's captured regions (its runners are
captured once as CUDA graphs by ``runtime.graphs``): ``rules_trace``,
the counterpart of the reference's trace-safety rule, is a source rule
here; ``graph_audit``, the counterpart of its jaxpr audit, traces the
real step functions with ``make_fx`` and runs under
``run_analysis(with_graphs=True)``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# src/repro_torch/analysis/engine.py -> repo root
REPO_ROOT = Path(__file__).resolve().parents[3]
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

SEVERITIES = ("error", "warning")

#: rule id -> one-line description (the rule catalog; DESIGN.md §analysis)
RULE_IDS: Dict[str, str] = {
    "source-parse": "a file does not parse (no rule can check it)",
    "cachekey-hashable": "a plan/spec/layout dataclass stopped being "
                         "hashable (cannot join a runner cache key)",
    "cachekey-missing": "a structural field does not join the "
                        "FlexiPipeline runner / packed-step cache key",
    "cachekey-unclassified": "a new field on a keyed dataclass has no "
                             "structural/data classification",
    "mask-parity": "segment/window/causal admissibility reimplemented "
                   "outside kernels/attention/mask.py",
    "mask-parity-import": "an attention backend does not import the "
                          "shared mask module",
    "telemetry-host-callback": "telemetry code calls a host callback "
                               "(taps must be data, not structure)",
    "telemetry-tap-host-sync": "tap tensors forced to the host on the "
                               "dispatch path (.item/.cpu/np.asarray/float "
                               "outside the aggregate sink)",
    "telemetry-attribution-device": "telemetry/attribution.py touches "
                                    "torch/numpy/device values — attribution "
                                    "runs on the serving hot path and must "
                                    "stay pure host integer arithmetic",
    "fleet-host-pure": "a fleet control module (router/membership/health) "
                       "imports torch/numpy or syncs a device value — "
                       "placement must stay pure host bookkeeping",
    "resilience-host-pure": "resilience/faults.py or journal.py imports "
                            "torch/numpy or syncs a device value — fault "
                            "scheduling and journaling run inside the "
                            "fleet tick and must stay pure host "
                            "bookkeeping",
    "trace-host-cast": "int()/float()/bool()/.item()/.cpu()/.tolist()/"
                       ".numpy() of a device value inside a captured "
                       "region (a sync: the capture fails)",
    "trace-host-copy": "a host-to-device copy (torch.from_numpy(...).to, "
                       "torch.as_tensor/torch.tensor with device=) inside "
                       "a captured region",
    "trace-python-branch": "Python if/while on a device value inside a "
                           "captured region",
    "trace-python-loop": "Python for-loop over a device value inside a "
                         "captured region",
    "trace-len": "len() of a device value inside a captured region",
    "trace-fstring": "f-string of a device value inside a captured region",
    "trace-host-np": "host numpy call on device values inside a captured "
                     "region",
    "hot-host-sync": "a device read inside a host loop (one blocking "
                     "transfer per iteration)",
    "graph-fingerprint-drift": "a captured step's make_fx graph differs "
                               "across a data-only switch (it would "
                               "capture again)",
    "graph-trace-failure": "an audited step no longer traces",
    "graph-host-sync": "a host read (aten._local_scalar_dense, .item) in "
                       "an audited step's graph",
    "graph-dtype-promotion": "a silent bf16->f32 / f32->f64 widening in "
                             "an audited step's graph",
    "graph-tap-structure": "dropping the tap outputs does not recover the "
                           "untapped step's graph",
    "graph-uncaptured-runner": "a runner FlexiPipeline._lookup built does "
                               "not go through runtime.graphs",
    "resilience-armed-guard": "a fault-injection seam call "
                              "(self._faults/_injector/faults) outside "
                              "an `is not None` guard — seams are "
                              "Optional on the hot path; unguarded calls "
                              "break disarmed runs",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str                 # 'error' | 'warning'
    path: str                     # repo-relative posix path
    line: int
    message: str
    symbol: str = "<module>"      # enclosing function qualname

    def baseline_key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.severity}: "
                f"{self.message} (in {self.symbol})")


def relpath(path: Path) -> str:
    path = Path(path).resolve()
    try:
        return path.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


# ---------------------------------------------------------------------------
# Inline suppressions

_IGNORE_RE = re.compile(r"#\s*repro:\s*ignore(?:\[([\w\-, ]+)\])?")


def parse_suppressions(text: str) -> Dict[int, Optional[frozenset]]:
    """1-based line -> suppressed rule ids (None = all rules)."""
    out: Dict[int, Optional[frozenset]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        ids = m.group(1)
        out[i] = (None if ids is None else
                  frozenset(s.strip() for s in ids.split(",") if s.strip()))
    return out


def _suppressed(f: Finding, sup: Dict[int, Optional[frozenset]]) -> bool:
    rules = sup.get(f.line, False)
    if rules is False:
        return False
    return rules is None or f.rule in rules


# ---------------------------------------------------------------------------
# Baseline

def load_baseline(path: Path = BASELINE_PATH) -> List[dict]:
    if not Path(path).exists():
        return []
    data = json.loads(Path(path).read_text())
    entries = data.get("findings", [])
    for e in entries:
        for field in ("rule", "path", "symbol", "justification"):
            if field not in e:
                raise ValueError(f"baseline entry {e} missing {field!r} "
                                 f"(every grandfathered finding needs a "
                                 f"justification)")
    return entries


def split_baselined(findings: Sequence[Finding],
                    baseline: Sequence[dict]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """(new, grandfathered). A baseline entry absorbs every finding with
    its ``rule:path:symbol`` key — the key is line-free on purpose."""
    keys = {f"{e['rule']}:{e['path']}:{e['symbol']}" for e in baseline}
    new = [f for f in findings if f.baseline_key() not in keys]
    old = [f for f in findings if f.baseline_key() in keys]
    return new, old


def baseline_entries(findings: Sequence[Finding],
                     justification: str = "TODO: justify") -> List[dict]:
    """Deduped baseline entries for ``findings`` (the --write-baseline
    path; edit the justifications before committing)."""
    seen, out = set(), []
    for f in findings:
        k = f.baseline_key()
        if k in seen:
            continue
        seen.add(k)
        out.append({"rule": f.rule, "path": f.path, "symbol": f.symbol,
                    "justification": justification})
    return out


# ---------------------------------------------------------------------------
# File iteration + rule dispatch

def iter_py_files(paths: Iterable[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


def _load_rules():
    # local import: rule modules import Finding from here
    from repro_torch.analysis import (rules_cachekey, rules_fleet, rules_mask,
                                      rules_resilience, rules_telemetry,
                                      rules_trace)
    source_rules = [rules_trace.TraceSafetyRule(),
                    rules_telemetry.TelemetryRule(),
                    rules_fleet.FleetHostPureRule(),
                    rules_resilience.ResilienceHostPureRule(),
                    rules_resilience.ResilienceArmedGuardRule()]
    repo_rules = [rules_mask.MaskParityRule(),
                  rules_cachekey.CacheKeyRule()]
    return source_rules, repo_rules


def lint_paths(paths: Sequence[Path],
               collect_suppressed: bool = False) -> List[Finding]:
    """Run every Level-1 rule over ``paths`` (files or directories).
    Inline-suppressed findings are dropped (or returned too when
    ``collect_suppressed``, for the analyzer's own tests)."""
    source_rules, repo_rules = _load_rules()
    files: Dict[str, Tuple[ast.AST, str]] = {}
    sups: Dict[str, Dict[int, Optional[frozenset]]] = {}
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        text = path.read_text()
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            findings.append(Finding("source-parse", "error",
                                    relpath(path), e.lineno or 0,
                                    f"file does not parse: {e.msg}"))
            continue
        rel = relpath(path)
        files[rel] = (tree, text)
        sups[rel] = parse_suppressions(text)
        for rule in source_rules:
            findings.extend(rule.check(rel, tree, text))
    for rule in repo_rules:
        findings.extend(rule.check_repo(files))
    if collect_suppressed:
        return findings
    return [f for f in findings
            if not _suppressed(f, sups.get(f.path, {}))]


# ---------------------------------------------------------------------------
# Top-level entry (CLI, tests)

@dataclasses.dataclass
class AnalysisReport:
    new: List[Finding]
    baselined: List[Finding]
    fingerprints: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def new_errors(self) -> List[Finding]:
        return [f for f in self.new if f.severity == "error"]

    def ok(self) -> bool:
        return not self.new_errors


def run_analysis(paths: Sequence[Path], *, with_graphs: bool = True,
                 baseline_path: Path = BASELINE_PATH) -> AnalysisReport:
    """Every source rule over ``paths`` plus (optionally) the graph audit
    of the real step functions, split against the committed baseline."""
    findings = lint_paths(paths)
    fingerprints: Dict[str, str] = {}
    if with_graphs:
        from repro_torch.analysis import graph_audit
        report = graph_audit.audit_step_functions()
        findings.extend(report.findings)
        fingerprints = report.fingerprints
    new, old = split_baselined(findings, load_baseline(baseline_path))
    return AnalysisReport(new=new, baselined=old, fingerprints=fingerprints)
