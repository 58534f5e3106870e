"""One run of one cell: set-up, the measured window, the reference's
judgement and the metrics, all found by the names in ``BENCHMARK.json``.

A cell (a ``workloads`` entry) names a configuration and a traffic mix.
The configuration's file (its ``file``) names the fabric module
(``portbench/fabrics/<kind>.py``), the driver (``portbench/drivers/
<driver>.py``), the program's entry and its arguments, and the job size;
the mix is ``portbench/traffic/<traffic>.json`` and names the loop that
offers its requests (``portbench/loops/<loop>.py``); each metric is read
by ``portbench/metrics/<name>.py``, which may also watch the program in
the window (its ``watch``). Adding a cell adds files and entries and
edits none.

Set-up builds the fabric twice (the reference's arrays, the program's
TopologyDB), makes the jobs from the seed and routes one collective of
each job shape (the program's kernels build or load, its tables fill).
The loop then runs the window. Each job's first collective in the
window, and a reservoir of later ones drawn from the seed, are kept.
After the window the device's peak memory is read, the program's state
freed, and the reference judges what was kept. The JAX fence is checked
after the window and again once everything the run loads is loaded, just
before the result is handed back.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import random
import statistics
import sys
import time

from portbench.trace import Spans, profile

#: modules no run may load, compared by whole top-level name
FENCED = ("jax", "jaxlib", "flax", "sdnmpi_tpu")
#: collectives kept and judged beyond each job's first, drawn from the seed
RESERVOIR = 2


def fenced_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FENCED))


def check_fence() -> None:
    fenced = fenced_modules()
    if fenced:
        raise FencedImport(fenced)


class Run:
    """What a run measured: the readers of ``portbench/metrics/`` take
    their numbers from it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.collectives = 0
        #: each collective's wall in the window, seconds
        self.walls: list[float] = []
        #: max link load of each job's first collective in the window
        self.job_loads: list[int] = []
        self.spans: Spans | None = None
        self.trace = None
        #: what each metric's ``watch`` recorded, by the metric's name
        self.records: dict[str, object] = {}


class Kept:
    """The answers the reference judges: request i for i < ``first``,
    and a reservoir of ``extra`` later ones drawn from the seed."""

    def __init__(self, first: int, extra: int, seed: int):
        self.first, self.extra = first, extra
        self.rng = random.Random(seed)
        self.answers: dict[int, object] = {}

    def __call__(self, n: int, answer) -> None:
        if n < self.first:
            self.answers[n] = answer
            return
        m = n - self.first
        if m < self.extra:
            self.answers[n] = answer
        elif (r := self.rng.randrange(m + 1)) < self.extra:
            later = sorted(k for k in self.answers if k >= self.first)
            del self.answers[later[r]]
            self.answers[n] = answer


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def metric_entries(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with a trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def metric_path(root: pathlib.Path, name: str) -> pathlib.Path:
    """``metrics/<name>.py``, or for a variant of a metric split by the
    end-to-end metric it moves (``dispatch_ms.phased``), the file of the
    part before the dot."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    return path if path.exists() else path.with_name(f"{name.split('.')[0]}.py")


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float) -> tuple[dict, list[str]]:
    """Run the cell ``workload``; returns the result line's object and
    the lines of the comparison (each number beside its limit)."""
    import torch

    from portbench import traffic

    marks = [("start to harness", time.perf_counter())]
    bench = load_json(root / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / entry["file"])
    run = Run()

    fabrics = importlib.import_module(f"portbench.fabrics.{cfg['fabric']['kind']}")
    fab = fabrics.reference_fabric(cfg["fabric"])
    mix = traffic.load(root, cell["traffic"])
    loop = importlib.import_module(f"portbench.loops.{mix['loop']}")
    jobs = traffic.make_jobs(mix, int(cfg["ranks"]), fab,
                             fabrics.placement(cfg["fabric"]),
                             float(cfg["link_capacity_bps"]), seed)
    marks.append(("fabric and jobs", time.perf_counter()))
    db = fabrics.program_db(cfg["fabric"], cfg.get("db_kwargs", {}), device)
    marks.append(("program DB", time.perf_counter()))
    run.spans = Spans(traced)
    drivers = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    driver = drivers.Driver(cfg, db, run.spans)

    # one collective of each job shape: kernels built or loaded, tables filled
    for shape in sorted({job.shape for job in jobs}):
        driver(next(j for j in jobs if j.shape == shape))
    sync(device)
    marks.append(("a collective of each job shape", time.perf_counter()))
    entries = metric_entries(bench, workload, traced)
    paths = {m["name"]: metric_path(root, m["name"]) for m in entries}
    loaded = {p: load_module(p) for p in set(paths.values())}
    # what set-up made (the jobs' utilization snapshots and pair arrays,
    # the program's tables, the interpreter's modules) is the steady heap
    # of a long-running controller: out of the collector's reach, so a
    # full collection in the window scans only what the window made
    gc.collect()
    gc.freeze()
    run.spans.done.clear()
    undo = [u for mod in loaded.values()
            if hasattr(mod, "watch") and (u := mod.watch(run)) is not None]
    kept = Kept(len(jobs), RESERVOIR, seed)
    marks.append(("collector frozen", time.perf_counter()))
    run.setup_s = time.perf_counter() - t_start

    def window():
        return loop.window(driver, jobs, seconds, kept)

    if traced:
        (run.collectives, run.window_s, run.walls), run.trace = profile(window)
    else:
        run.collectives, run.window_s, run.walls = window()
    for u in reversed(undo):
        u()

    check_fence()
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.close()
    del db
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    limits = driver.LIMITS
    totals = {name: 0 for name in limits}
    failed = 0
    judged = len(kept.answers)
    for n in sorted(kept.answers):
        counts, load = driver.judge(fab, jobs[n % len(jobs)], kept.answers.pop(n))
        if n < len(jobs):
            run.job_loads.append(load)
        failed += any(counts[k] > limits[k] for k in counts)
        for k, v in counts.items():
            totals[k] = max(totals[k], v) if k == "congestion_gap" else totals[k] + v
    judged_s = time.perf_counter() - t_ref

    metrics = {}
    for m in entries:
        value = loaded[paths[m["name"]]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": failed == 0,
        "attempted": run.collectives,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name() if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s()
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_breakdown()}
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in totals.items()}
    walls = [(name, t - t_prev) for (name, t), (_, t_prev)
             in zip(marks, [("", t_start)] + marks[:-1])]
    lines = ["set-up " + ", ".join(f"{name} {s:.3f} s" for name, s in walls)]
    q = statistics.quantiles(run.walls, n=4) if len(run.walls) > 1 else run.walls * 3
    lines += [f"window {run.collectives} collectives in {run.window_s:.3f} s; walls ms "
              f"min {1e3 * min(run.walls):.3f} quartiles "
              + " ".join(f"{1e3 * x:.3f}" for x in q)
              + f" max {1e3 * max(run.walls):.3f}"]
    lines += [f"judged {judged} of {run.collectives} collectives in {judged_s:.3f} s"]
    lines += [f"check {k}: {v} (limit {limits[k]})" for k, v in totals.items()]
    # last, once every module the run uses is loaded
    check_fence()
    return result, lines


class FencedImport(RuntimeError):
    def __init__(self, names: list[str]):
        super().__init__(f"fenced modules loaded: {', '.join(names)}")
        self.names = names
