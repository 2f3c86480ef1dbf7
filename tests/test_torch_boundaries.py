"""Boundaries of the port: what it imports, where it runs, and which
options of the JAX package it does not take yet."""

import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch import native
from lbfgspp_tpu_torch.ops import history
from lbfgspp_tpu_torch.utils import objectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lbfgspp_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_no_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "lbfgspp_tpu"), (path, mod)


def _csrc_sources():
    csrc = os.path.join(PORT, "csrc")
    for dirpath, _, files in os.walk(csrc):
        for f in files:
            yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_csrc_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_sources_include_only_the_ports_own(path):
    """A quoted include of the port's C++/CUDA sources names a file beside
    it: nothing of lbfgspp_tpu/native/ (its core.cpp, lbfgsb.cpp) is
    compiled into the port."""
    with open(path) as f:
        for line in f:
            if line.startswith('#include "'):
                name = line.split('"')[1]
                assert os.path.exists(os.path.join(os.path.dirname(path),
                                                   name)), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, lbfgspp_tpu_torch, lbfgspp_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lbfgspp_tpu', 'triton')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _entry_points():
    x0 = torch.zeros(2, 4)
    p = T.LBFGSParams(max_iterations=5)
    return {
        "minimize": lambda **kw: T.minimize(objectives.quadratic, x0, p,
                                            **kw),
        "minimize_batched": lambda **kw: T.minimize_batched(
            objectives.quadratic, x0, p, **kw),
        "solver": lambda **kw: T.solver(objectives.quadratic, p, **kw),
        "init_history": lambda **kw: history.init_history(2, 4, 3, **kw),
        "minimize_owlqn": lambda **kw: T.minimize_owlqn(
            objectives.quadratic, x0, 0.1, p, **kw),
        "polish_solve_owlqn": lambda **kw: T.polish_solve_owlqn(
            objectives.quadratic, x0, 0.1, p, 2, **kw),
        "minimize_stochastic": lambda **kw: T.minimize_stochastic(
            lambda w, rows: torch.sum((w - rows) ** 2), torch.zeros(4),
            torch.zeros(8, 4), p, batch_size=4, **kw),
        "implicit_minimize": lambda **kw: T.implicit_minimize(
            lambda x, t: torch.sum((x - t) ** 2), x0, torch.zeros(2, 4), p,
            **kw),
        "minimize_pytree": lambda **kw: T.minimize_pytree(
            lambda t: torch.sum(t["a"] ** 2), {"a": torch.ones(3)}, p, **kw),
        "native.minimize": lambda **kw: native.minimize(
            "rosenbrock", torch.zeros(4), p, **kw),
        "native.minimize_b": lambda **kw: native.minimize_b(
            "rosenbrock", torch.zeros(4), -1.0, 1.0, **kw),
        "native.minimize_batch": lambda **kw: native.minimize_batch(
            "quadratic", x0, p, **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    """With no card, an entry point called without ``device=`` (or with a
    CUDA device) raises; it never drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="CUDA"):
        call(device="cuda")
    call(device="cpu")


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("polish_iters", 5),
    ("polish_params", T.LBFGSParams()),
    ("polish_warm", True), ("polish_shift", True),
    ("polish_on_ls_fail", "restart"), ("polish_restarts", 2),
    ("refine_frac", 0.1), ("refine_iters", 10), ("deep_frac", 0.1),
    ("deep_iters", 60), ("deep_selection", "hstep"),
])
def test_unported_minimize_batched_options_raise(option, value):
    """Every one of the JAX package's minimize_batched options is taken
    (``mesh`` was the last to raise), and its default (the JAX
    package's) leaves the result as it is without it; ``mesh`` as a
    process group of one rank gives the result without it too."""
    x0 = torch.zeros(2, 4)
    default = inspect.signature(T.minimize_batched).parameters[option]

    def call(**kw):
        return T.minimize_batched(objectives.quadratic, x0,
                                  T.LBFGSParams(max_iterations=5),
                                  device="cpu", **kw)

    plain = call()
    same = call(**{option: default.default})
    assert all(torch.equal(a, b) for a, b in zip(plain[:7], same[:7]))
    if option == "mesh":
        import torch.distributed as dist
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            meshed = call(mesh=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
        assert all(torch.equal(a, b) for a, b in zip(plain[:7], meshed[:7]))
    else:
        assert torch.isfinite(call(**{option: value}).x).all()


def test_unknown_minimize_batched_option_is_a_type_error():
    with pytest.raises(TypeError, match="polish_iterations"):
        T.minimize_batched(objectives.quadratic, torch.zeros(2, 4),
                           device="cpu", polish_iterations=3)
