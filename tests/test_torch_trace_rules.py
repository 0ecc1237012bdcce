"""The port's capture-safety rule (``repro_torch/analysis/rules_trace.py``),
the counterparts of the JAX package's trace-safety tests
(``tests/test_analysis.py``, its flagged and passing fixtures, the
``# repro: traced`` marker and ``hot-host-sync``) with torch fixtures: a
region is a body handed to ``runtime.graphs.capture`` (its ``host=``
function is not one), a function a ``make_*`` factory returns, or a def
marked ``# repro: traced``. Then the rule on the port's own tree: strict
against the committed baseline, and the regions it finds in the
pipeline's runners.
"""
import ast
import textwrap

from torch_threads import one_torch_thread  # noqa: F401

from repro_torch.analysis import engine
from repro_torch.analysis import rules_trace
from repro_torch.analysis.__main__ import main

PORT_SRC = engine.REPO_ROOT / "src" / "repro_torch"


def _lint_src(tmp_path, name, src, **kw):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return engine.lint_paths([p], **kw)


def _rules(findings):
    return {f.rule for f in findings}


BAD_CAPTURED = """
    import numpy as np
    import torch
    from repro_torch.runtime import graphs

    def step(x, t):
        if t.sum() > 0:
            x = x + 1
        n = int(torch.sum(x))
        k = len(x)
        msg = f"value={x}"
        y = np.abs(x)
        z = x.cpu() + torch.as_tensor(np.ones(3), device=x.device)
        w = torch.from_numpy(np.ones(3)).to(x.device)
        for row in x:
            y = y + row
        return x * n + y + z.tolist()[0] + w

    runner = graphs.capture(step)
"""

GOOD_CAPTURED = """
    import torch
    from repro_torch.runtime import graphs

    def host(x, t, refresh):
        return bool(refresh), (x, t)

    def step(deep, x, t, flag=None):
        if flag is None:
            x = x * 2
        if x.ndim == 3:
            x = x[None]
        if deep:
            x = x + 1
        n = x.shape[0]
        return torch.where(t > 0, x + 1.0, x) * n

    runner = graphs.capture(step, host=host)
"""


def test_trace_rules_flag_bad_fixture(tmp_path):
    found = _lint_src(tmp_path, "bad.py", BAD_CAPTURED)
    assert {"trace-python-branch", "trace-host-cast", "trace-len",
            "trace-fstring", "trace-host-np", "trace-host-copy",
            "trace-python-loop"} <= _rules(found)
    casts = sorted(f.message.split()[0] for f in found
                   if f.rule == "trace-host-cast")
    assert casts == [".cpu()", ".tolist()", "int()"]
    assert {f.line for f in found if f.rule == "trace-host-copy"} == {13, 14}
    assert all(f.symbol == "step" for f in found)


def test_trace_rules_pass_good_fixture(tmp_path):
    assert _lint_src(tmp_path, "good.py", GOOD_CAPTURED) == []


def test_host_function_and_factory_regions(tmp_path):
    """``host=`` runs outside the capture; a ``make_*`` factory's returned
    function is a region (its caller captures it)."""
    src = """
        import torch
        from repro_torch.runtime import graphs

        def host(x, flags):
            return bool(flags.any()), (x,)

        def make_step_fn(scale):
            def step(x):
                return x * float(torch.mean(x))
            return step

        r = graphs.capture(lambda branch, x: x, host=host)
    """
    found = _lint_src(tmp_path, "m.py", src)
    assert [(f.rule, f.symbol) for f in found] == [("trace-host-cast", "step")]


def test_traced_marker_extends_coverage(tmp_path):
    src = """
        import torch

        def helper(x):  # repro: traced
            return int(torch.sum(x))
    """
    assert "trace-host-cast" in _rules(_lint_src(tmp_path, "m.py", src))
    # without the marker the function is host code: int() on a device
    # value is only flagged inside loops (hot-host-sync)
    assert _lint_src(tmp_path, "n.py", src.replace("# repro: traced", "")) \
        == []


def test_hot_host_sync_rule(tmp_path):
    bad = """
        import torch

        def drive(xs):
            out = []
            for x in xs:
                out.append(float(torch.mean(x)))
                out.append(torch.mean(x).item())
            return out
    """
    good = """
        import torch

        def drive(xs):
            total = torch.mean(torch.stack([torch.mean(x) for x in xs]))
            return float(total)
    """
    found = _lint_src(tmp_path, "bad.py", bad)
    assert [f.rule for f in found] == ["hot-host-sync"] * 2
    assert _lint_src(tmp_path, "good.py", good) == []


def test_suppression_of_a_trace_finding(tmp_path):
    src = """
        import torch

        def helper(x):  # repro: traced
            return int(torch.sum(x))  # repro: ignore[trace-host-cast]
    """
    assert _lint_src(tmp_path, "m.py", src) == []
    assert _rules(_lint_src(tmp_path, "m.py", src, collect_suppressed=True)) \
        == {"trace-host-cast"}


def test_regions_of_the_port_runners():
    """The pipeline's captured bodies are regions: the static and flow
    runners' ``run``, the cached NFE, and (marked) the packed step's
    micro-step and its forward; the host loops are not."""
    def regions(rel):
        text = (engine.REPO_ROOT / rel).read_text()
        marked = {i for i, line in enumerate(text.splitlines(), start=1)
                  if rules_trace._TRACED_MARK.search(line)}
        found = rules_trace.find_traced_regions(ast.parse(text), marked)
        return {(getattr(n, "name", "<lambda>"), n.lineno) for n in found}

    pipe = regions("src/repro_torch/pipeline/pipeline.py")
    names = {n for n, _ in pipe}
    assert {"run", "nfe", "fn"} <= names
    runs = sorted(line for n, line in pipe if n == "run")
    assert len(runs) == 2 and "loop" not in names   # static and flow
    packed = {n for n, _ in regions("src/repro_torch/pipeline/packed.py")}
    assert {"micro", "one_step"} <= packed
    # host data is prepared there; body is the host loop over micro-steps
    assert not {"host", "step", "body"} & packed


def test_trace_rules_strict_on_the_port(capsys):
    """``python -m repro_torch.analysis --strict`` on the port's tree
    against the committed baseline (the graph audit runs in
    ``tests/test_torch_analysis.py`` and ``tests/test_torch_graph_audit``):
    no new error, and every trace-rule entry of the baseline is live."""
    assert main(["--strict", "--no-graphs", str(PORT_SRC)]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    live = {f.baseline_key() for f in engine.lint_paths([PORT_SRC])}
    trace_entries = [e for e in engine.load_baseline()
                     if e["rule"].startswith(("trace-", "hot-host"))]
    assert trace_entries
    for e in trace_entries:
        assert f"{e['rule']}:{e['path']}:{e['symbol']}" in live
