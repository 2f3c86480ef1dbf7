"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
and its metrics come from ``BENCHMARK.json`` and the files named after
them under ``portbench/`` (see README.md).  A run loads and warms up (the
set-up, timed as ``setup_s``), measures for ``--seconds`` seconds in a
closed loop (one unit in flight), reads the device's
peak memory, frees the program's state, has the plain reference judge a
sample of what the window produced, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window.

A cell on one card runs in this process.  A cell on ``chips`` cards
starts as many rank processes (:func:`launch`), rank r on ``cuda:r``, all
in one NCCL group joined through a rendezvous file over loopback; each
runs the whole of :func:`run_cell` in lockstep, and this process merges
their results into the one line (:func:`merge`).
"""

import time

_T0 = time.perf_counter()
# the same instant on the clock every process of the host shares
_M0 = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lbfgspp_tpu")
EXIT_NO_DEVICE, EXIT_BUSY, EXIT_FORBIDDEN = 3, 4, 5
EXIT_RANK, EXIT_LIMIT = 6, 7
# a multi-card run's limit, inside the 360 s a run may take
RANK_LIMIT_S = 330.0


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


def _usage(dev) -> dict:
    """This process's CPU seconds so far, and its card allocator's
    retries, device allocations and frees."""
    import resource

    import torch
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = dict(cpu_s=ru.ru_utime + ru.ru_stime)
    if dev.type == "cuda":
        st = torch.cuda.memory_stats(dev)
        out.update(alloc_retries=st.get("num_alloc_retries", 0),
                   device_allocs=st.get("num_device_alloc", 0),
                   device_frees=st.get("num_device_free", 0))
    return out


class _Collections:
    """The garbage collector's passes while this is in ``gc.callbacks``:
    by generation, ``[count, seconds, longest]``."""

    def __init__(self):
        self.by_gen, self._t = {}, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        took = time.perf_counter() - self._t
        c = self.by_gen.setdefault(info["generation"], [0, 0.0, 0.0])
        c[0], c[1], c[2] = c[0] + 1, c[1] + took, max(c[2], took)


def _agree(stop: bool, group, dev) -> bool:
    """Rank 0's decision, broadcast to every rank of ``group``."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(stop)], device=dev)
    dist.broadcast(flag, 0, group=group)
    return bool(flag.item())


def run_cell(spec, cell, cfg, traffic, seed: int, seconds: float,
             trace: bool, device, answers=None, group=None, rank: int = 0,
             world: int = 1, prepare=None) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, reference.

    ``answers(sample, ctx) -> sample`` puts other answers in the program's
    place before the reference judges them, and ``prepare(ctx)`` may change
    what the entry builds (the controls, portbench/control.py); a run of
    the benchmark passes neither.

    ``group``, ``rank``, ``world``: the ``torch.distributed`` group of a
    multi-card run and this process's place in it (the entry and the
    reference see them as ``ctx.group``, ``ctx.rank``, ``ctx.world``); rank
    0's clock ends the window, and its decision is broadcast after every
    unit, so that every rank runs the same units.

    Returns the result line's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks``, and traced
    ``breakdown``), plus ``setup_s``, ``window_start`` (on
    ``time.monotonic``), ``numbers`` (every number the reference gave) and
    ``trace`` (the window's summary)."""
    import torch
    from portbench import trace as tr
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=int(seed), device=dev,
        trace=bool(trace), group=group, rank=int(rank), world=int(world),
        objective=load_module("objectives", traffic["objective"]))
    if prepare is not None:
        prepare(ctx)
    entry = load_module("entries", traffic["entry"]).make(ctx)
    marks = dict(built=time.monotonic())

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    entry.warm()
    sync()
    marks["warmed"] = time.monotonic()
    usage = collections = None
    if group is not None:
        usage, collections = _usage(dev), _Collections()
        gc.callbacks.append(collections)
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
        window_start = time.monotonic()
        while True:
            u0 = time.perf_counter()
            with torch.profiler.record_function("portbench.unit"):
                a, f, g = entry.unit(units)
            unit_s.append(time.perf_counter() - u0)
            units, attempted, failed, good = (units + 1, attempted + a,
                                              failed + f, good + g)
            stop = time.perf_counter() - start >= seconds or (
                cap is not None and units >= cap)
            if group is not None:
                stop = _agree(stop, group, dev)
            if stop:
                break
        sync()
        window_s = time.perf_counter() - start
    if usage is not None:
        gc.callbacks.remove(collections)
        usage = {k: v - usage[k] for k, v in _usage(dev).items()}
        usage["gc"] = {g: [n, round(t, 4), round(m, 4)]
                       for g, (n, t, m) in sorted(collections.by_gen.items())}
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
    if group is not None:
        half = 0.5 * sum(unit_s)
        first = sum(1 for t in itertools.accumulate(unit_s) if t <= half)
        _log(f"rank {rank}: set-up {setup_s:.3f} s, window {window_s:.3f} "
             f"s, {units} units ({first} in its first half of unit time), "
             f"peak {peak} bytes; window's {usage}")
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
    marks["window"] = window_start
    out.update(setup_s=setup_s, window_start=window_start, marks=marks,
               numbers=numbers,
               trace=summary, counters=counters, extras=extras, units=units,
               unit_s=unit_s)
    return out


# what a rank hands the launcher
RANK_KEYS = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks", "window_start", "numbers", "counters",
             "units", "marks")


def rank_main(task_dir: str, rank: int) -> int:
    """A rank of :func:`launch`: join the group, run the cell, check the
    traced window and the loaded modules, write ``result<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from portbench.trace import BusyCheckError, check_busy
    task = load_json(task_dir, "task.json")
    world = int(task["world"])
    device = "cpu"
    if task["kind"] == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(
        task["backend"],
        init_method="file://" + os.path.join(task_dir, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(task["limit_s"]) + 60))
    joined = time.monotonic()
    code = 0
    try:
        prepare = answers = None
        if task.get("hooks"):
            module, name = task["hooks"].split(":")
            prepare, answers = getattr(importlib.import_module(module),
                                       name)(*task.get("hook_args", []))
        out = run_cell(task["spec"], task["cell"], task["cfg"],
                       task["traffic"], task["seed"], task["seconds"],
                       bool(task["trace"]), device, answers=answers,
                       group=dist.group.WORLD, rank=rank, world=world,
                       prepare=prepare)
        if task["trace"] and device != "cpu":
            try:
                check_busy(out["device"]["busy_s"],
                           out["device"]["window_s"])
            except BusyCheckError as e:
                _log(f"rank {rank}: traced window refused: {e}")
                code = EXIT_BUSY
        found = forbidden_loaded()
        if found:
            _log(f"rank {rank}: forbidden modules loaded: {found}")
            code = EXIT_FORBIDDEN
        t0 = float(task["t0"])
        marks = dict(start=_M0, joined=joined, **out["marks"])
        _log(f"rank {rank}: set-up marks from the launcher's start "
             f"{ {k: round(v - t0, 3) for k, v in marks.items()} }")
        _log(f"rank {rank}: units {out['units']} counters "
             f"{out['counters']} extras {out['extras']} numbers "
             f"{out['numbers']}")
        with open(os.path.join(task_dir, f"result{rank}.json"), "w") as f:
            json.dump({k: out[k] for k in RANK_KEYS if k in out}, f)
    except BaseException:
        # leave at once: the other ranks may wait in a collective, and the
        # group's teardown would wait with them
        traceback.print_exc()
        code = 1
    if code:
        sys.stderr.flush()
        os._exit(code)
    dist.destroy_process_group()
    return 0


def _worst(values):
    """The largest value, NaN if any is NaN (every limit is an upper
    one)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def merge(results, trace: bool) -> dict:
    """The result line of a multi-card run from its ranks' results:
    ``attempted``, ``failed`` and (untraced) the metrics of rank 0; the
    fullest card's peak; traced, ``busy_s``, ``window_s``, ``breakdown``
    and the per-layer metrics of the least busy card; every check at its
    worst over the ranks; ``setup_s`` from this process's start to rank
    0's window."""
    r0 = results[0]
    pick = r0
    if trace:
        pick = min(results, key=lambda r: r["device"]["busy_s"] /
                   r["device"]["window_s"])
    checks = {k: dict(value=_worst([r["checks"][k]["value"]
                                    for r in results]),
                      limit=c["limit"]) for k, c in r0["checks"].items()}
    correct = all(r["correct"] for r in results) and \
        r0["attempted"] > 0 and r0["failed"] == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in checks.values())
    device = dict(r0["device"], count=len(results), memory_peak_bytes=max(
        r["device"]["memory_peak_bytes"] for r in results))
    metrics = dict(pick["metrics"])
    if trace:
        device.update(busy_s=pick["device"]["busy_s"],
                      window_s=pick["device"]["window_s"])
    else:
        metrics["setup_s"] = dict(value=float(r0["window_start"] - _M0),
                                  unit="s")
    out = dict(correct=bool(correct), attempted=int(r0["attempted"]),
               failed=int(r0["failed"]), metrics=metrics, device=device)
    if trace:
        out["breakdown"] = pick["breakdown"]
    out["checks"] = checks
    out.update(numbers=r0["numbers"], counters=r0["counters"],
               units=r0["units"], cards=[r["device"] for r in results])
    return out


def launch(spec, cell, cfg, traffic, seed: int, seconds: float,
           trace: bool, world: int, kind: str = "cuda",
           backend: str = "nccl", hooks=None, hook_args=(),
           limit_s=None):
    """Run ``cell`` on ``world`` fresh rank processes; ``(0, merged
    result)``, or ``(code, None)`` once a rank has failed or the run has
    outlasted its limit (``limit_s``, else :data:`RANK_LIMIT_S`), every
    rank then killed.  The ranks rendezvous through a file in a temporary directory
    and open nothing beyond loopback; their output goes to standard error.
    ``hooks`` ("module:function", called with ``hook_args`` in every rank)
    returns the rank's ``(prepare, answers)`` (the controls)."""
    limit = float(limit_s or RANK_LIMIT_S)
    tmp = tempfile.mkdtemp(prefix="portbench-ranks-")
    procs = []
    try:
        with open(os.path.join(tmp, "task.json"), "w") as f:
            json.dump(dict(spec=spec, cell=cell, cfg=cfg, traffic=traffic,
                           seed=int(seed), seconds=float(seconds),
                           trace=bool(trace), world=int(world), kind=kind,
                           backend=backend, hooks=hooks,
                           hook_args=list(hook_args), limit_s=limit,
                           t0=_M0), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        # a rank's tensors are few and large: segments that grow keep the
        # allocator's cached blocks from splitting the card's memory
        env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.run", "--rank-task", tmp,
                 str(rank)], stdout=2, env=env, cwd=ROOT))
        deadline = time.monotonic() + limit
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                _log(f"rank {bad[0]} exited with {codes[bad[0]]}; every "
                     "rank ended")
                return EXIT_RANK, None
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _log(f"the run outlasted its limit of {limit} s; every "
                     "rank ended")
                return EXIT_LIMIT, None
            time.sleep(0.05)
        results = [load_json(tmp, f"result{r}.json") for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(results):
        if trace:
            d = res["device"]
            _log(f"card {r}: busy_s {d['busy_s']!r} window_s "
                 f"{d['window_s']!r}")
    return 0, merge(results, trace)


def _print_checks(out) -> None:
    for k, c in out["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")


def line_of(out) -> str:
    """The contract's result line; ``checks`` comes last."""
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: out[k] for k in keys if k in out})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank-task"]:
        return rank_main(argv[1], int(argv[2]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    spec, cell, cfg, traffic = resolve(args.workload)
    chips = int(cell["chips"])
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        _log(f"the cell needs {chips} CUDA device(s); found {found}")
        return EXIT_NO_DEVICE
    if chips > 1:
        rc, out = launch(spec, cell, cfg, traffic, args.seed, args.seconds,
                         bool(args.trace), chips)
        if rc:
            return rc
        found = forbidden_loaded()
        if found:
            _log(f"forbidden modules loaded: {found}")
            return EXIT_FORBIDDEN
        _log(f"setup_s {out['metrics'].get('setup_s')} units "
             f"{out['units']} counters {out['counters']} numbers "
             f"{out['numbers']} cards {out['cards']}")
        _print_checks(out)
        print(line_of(out), flush=True)
        return 0
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
