"""Every cell, configuration and metric of BENCHMARK.json resolves to its
files, and nothing under portbench/ imports JAX or the JAX package."""

import ast
import json
import os
import re

import pytest

from portbench import run

SPEC = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "lbfgspp_tpu"}


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    spec, w, cfg, traffic = run.resolve(cell["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    assert cfg["name"] == w["config"]
    for kind in ("entries", "objectives"):
        key = "entry" if kind == "entries" else "objective"
        assert os.path.exists(os.path.join(run.HERE, kind,
                                           traffic[key] + ".py"))
    ref = run.load_module("reference", w["config"])
    assert callable(ref.judge)
    assert traffic["limits"] and traffic["control"]
    reported = run.metrics_of(spec, w["name"], False)
    assert reported, "a cell reports an end-to-end metric besides setup_s"
    assert run.metrics_of(spec, w["name"], True)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if metric["name"] == "setup_s":
        return
    mod = run.reader(metric["name"])
    assert callable(mod.read)
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "layer" in metric:
        e2e = {m["name"]: m for m in SPEC["end_to_end"]}
        assert metric["moves"] in e2e
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", cells))


def test_a_cells_name_of_a_metric_shares_its_reader():
    assert run.reader("idle_share.multistart").__file__.endswith(
        os.path.join("metrics", "idle_share.py"))
    assert run.reader("solves_per_s.a.b").__file__.endswith(
        os.path.join("metrics", "solves_per_s.py"))
    with pytest.raises(FileNotFoundError):
        run.reader("no_such_metric.multistart")


def test_configs_and_bounds():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(len(k) <= 200 for k in layers)
    assert len(json.dumps(SPEC)) < 64 * 1024


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_no_jax_under_portbench():
    """Top-level names compared whole: lbfgspp_tpu_torch is the port."""
    found = []
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                found += [(path, m) for m in _imports(path)
                          if m.split(".")[0] in FORBIDDEN]
    assert not found


def test_the_import_check_compares_whole_names():
    assert "lbfgspp_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "lbfgspp_tpu.native".split(".")[0] in FORBIDDEN
