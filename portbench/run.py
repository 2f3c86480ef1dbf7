"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
and its metrics come from ``BENCHMARK.json`` and the files named after
them under ``portbench/`` (see README.md).  A run loads and warms up (the
set-up, timed as ``setup_s``), measures for ``--seconds`` seconds in a
closed loop (one batch in flight), reads the device's
peak memory, frees the program's state, has the plain reference judge a
sample of what the window produced, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lbfgspp_tpu")
EXIT_NO_DEVICE, EXIT_BUSY, EXIT_FORBIDDEN = 3, 4, 5


def _log(*args) -> None:
    print("portbench:", *args, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str):
    """``(spec, workload, cfg, traffic)`` of the cell ``name``."""
    spec = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return (spec, cell, load_json(ROOT, conf["file"]),
            load_json(HERE, "traffic", cell["traffic"] + ".json"))


def reader(name: str):
    """The reader of the metric ``name``: ``metrics/<name>.py``, else that
    of ``name`` less its last dotted part (``idle_share.multistart`` reads
    with ``metrics/idle_share.py``), so that the cells' own names of one
    quantity share one reader."""
    while True:
        try:
            return load_module("metrics", name)
        except FileNotFoundError:
            if "." not in name:
                raise
            name = name.rsplit(".", 1)[0]


def metrics_of(spec, cell: str, trace: bool):
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced (``setup_s`` apart), the per-layer ones traced."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if cell in m.get("workloads", [cell]) and m["name"] != "setup_s"]


def forbidden_loaded():
    return sorted({k.split(".")[0] for k in list(sys.modules)} &
                  set(FORBIDDEN))


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its own into ``lbfgspp_tpu_torch/_build``)."""
    base = os.path.join(ROOT, "portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(spec, cell, cfg, traffic, seed: int, seconds: float,
             trace: bool, device, answers=None) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, reference.

    ``answers(sample, ctx) -> sample`` puts other answers in the program's
    place before the reference judges them (the controls, portbench/
    control.py); a run of the benchmark passes none.

    Returns the result line's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks``, and traced
    ``breakdown``), plus ``setup_s``, ``numbers`` (every number the
    reference gave) and ``trace`` (the window's summary)."""
    import torch
    from portbench import trace as tr
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=int(seed), device=dev,
        trace=bool(trace),
        objective=load_module("objectives", traffic["objective"]))
    entry = load_module("entries", traffic["entry"]).make(ctx)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    entry.warm()
    sync()
    cap = traffic.get("trace_units") if trace else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
    before = entry.counters()
    units, unit_s, good, attempted, failed = 0, [], 0, 0, 0
    with torch.profiler.record_function(tr.WINDOW_SPAN):
        start = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            with torch.profiler.record_function("portbench.unit"):
                a, f, g = entry.unit(units)
            unit_s.append(time.perf_counter() - u0)
            units, attempted, failed, good = (units + 1, attempted + a,
                                              failed + f, good + g)
            if time.perf_counter() - start >= seconds or (
                    cap is not None and units >= cap):
                break
        sync()
        window_s = time.perf_counter() - start
    after = entry.counters()
    if prof is not None:
        prof.stop()
    counters = {k: after[k] - before.get(k, 0) for k in after}
    extras = entry.extras()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = None
    if prof is not None:
        summary = tr.summarize(tr.events_of(prof),
                               dev.index if dev.index is not None else 0)
        del prof
    setup_s = start - _T0
    reading = dict(units=units, unit_s=unit_s, window_s=window_s, good=good,
                   attempted=attempted, failed=failed, counters=counters,
                   extras=extras, trace=summary, cfg=cfg, traffic=traffic)
    metrics = {}
    for m in metrics_of(spec, cell["name"], trace):
        value = reader(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    if not trace:
        metrics["setup_s"] = dict(value=float(setup_s), unit="s")
    sample = entry.sample()
    del entry
    if answers is not None:
        sample = answers(sample, ctx)
    r0 = time.perf_counter()
    numbers = load_module("reference", cell["config"]).judge(sample, ctx)
    numbers["reference_s"] = time.perf_counter() - r0
    limits = traffic["limits"]
    checks = {k: dict(value=float(numbers[k]), limit=float(v))
              for k, v in limits.items()}
    correct = attempted > 0 and failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = dict(
        platform="gpu" if on_card else dev.type,
        kind=torch.cuda.get_device_name(dev) if on_card else dev.type,
        count=1, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device_info)
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    out.update(setup_s=setup_s, numbers=numbers, trace=summary,
               counters=counters, units=units, unit_s=unit_s)
    return out


def _print_checks(out) -> None:
    for k, c in out["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")


def line_of(out) -> str:
    """The contract's result line; ``checks`` comes last."""
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: out[k] for k in keys if k in out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    spec, cell, cfg, traffic = resolve(args.workload)
    if int(cell["chips"]) != 1:
        raise SystemExit(f"portbench: {args.workload} asks for "
                         f"{cell['chips']} cards; the harness runs a cell "
                         "on one")
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not found:
        _log("the cell needs a CUDA device; found none")
        return EXIT_NO_DEVICE
    out = run_cell(spec, cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda:0")
    if args.trace:
        from portbench.trace import BusyCheckError, check_busy
        try:
            check_busy(out["device"]["busy_s"], out["device"]["window_s"])
        except BusyCheckError as e:
            _log(f"traced window refused: {e}")
            return EXIT_BUSY
        d = out["device"]
        _log(f"busy_s {d['busy_s']!r} window_s {d['window_s']!r}")
    found = forbidden_loaded()
    if found:
        _log(f"forbidden modules loaded: {found}")
        return EXIT_FORBIDDEN
    _log(f"setup_s {out['setup_s']!r} units {out['units']} counters "
         f"{out['counters']} numbers {out['numbers']} unit_s "
         f"{[round(t, 4) for t in out['unit_s']]}")
    _print_checks(out)
    print(line_of(out), flush=True)
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
