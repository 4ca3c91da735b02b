"""Run one cell of BENCHMARK.json on the card this process is started on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell names a configuration
(``portbench/configs/<config>.json``: the forest and its rows) and a
traffic mix (``portbench/traffic/<traffic>.json``), whose ``kind`` names
the load that drives it (``portbench/kinds/<kind>.py``, drive.py). Set-up
draws the forest and the rows from ``--seed``, builds
``tahoe_tpu_torch.engine.forest.Forest`` from the arrays
(``forest.spec.from_arrays``), takes the program's own pick of strategy
(``perf_model.model.choose_strategy`` at the load's request size, under
its default calibration) and warms up every shape the traffic uses.
The window then drives ``Forest.predict(rows, strategy)`` for ``--seconds``
seconds. With ``--trace 1`` a short slice that continues the traffic after
the window is traced (trace.py).

Once the window has closed and the peak memory has been read, the
program's engines are freed and the plain reference (reference.py) judges
every prediction the window and the slice produced: ``correct`` holds when
the widest gap, an answer that never came counting as the widest, is
within the configuration's limit.
Each number compared is printed beside its limit as the last lines of
standard error, and under ``checks``, the last key of the result line.

The metrics are the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), each read by ``metrics/<name>.py``.
The last line of standard output is the JSON result. Without a CUDA card
(or with fewer than the cell asks for), or where a module of jax, jaxlib,
flax or tahoe_tpu is loaded once the window has closed, it prints no result
and exits 2.
"""
from __future__ import annotations

import time

_T0 = time.monotonic()  # the harness's start, before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "tahoe_tpu")
# seconds of traffic the traced slice profiles, after the window
SLICE_S = 0.5


class NoResult(Exception):
    """A run that prints no result: the message says why."""


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise NoResult(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones (those
    that list it, or list no cells), or with ``trace`` the per-layer ones
    that list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", (cell["name"],))]


def load_file(root: Path, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` of the checkout at
    ``root``."""
    path = root / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.exists():
        raise NoResult(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_mix(root: Path, cell: dict) -> dict:
    return json.loads((root / "portbench" / "traffic"
                       / f"{cell['traffic']}.json").read_text())


def load_kind(root: Path, mix: dict):
    """The module of the mix's kind of load (drive.py)."""
    return load_file(root, "kinds", mix["kind"])


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Prepared(NamedTuple):
    """A cell set up and warmed: its configuration, the program, the load
    that drives it, the pick, and the set-up's phases in seconds."""

    config: dict
    prog: object
    load: object
    strategy: object
    phases: dict


def check_device(cell: dict, dev) -> None:
    import torch

    if dev.type != "cuda":
        return
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        raise NoResult(f"{cell['name']} asks for {cell['chips']} CUDA "
                       f"device(s); found {found}")


def prepare(root: Path, cell: dict, seed: int, dev) -> Prepared:
    """Set-up: the forest and rows from ``seed``, the program, its pick at
    the load's request size, and every shape warmed up."""
    from portbench import drive
    from portbench.generators import forest_of

    phases, t = {}, time.monotonic()

    def mark(name):
        nonlocal t
        now = time.monotonic()
        phases[name] = now - t
        t = now

    from tahoe_tpu_torch.engine.forest import Forest
    from tahoe_tpu_torch.forest.spec import from_arrays
    from tahoe_tpu_torch.perf_model.model import choose_strategy

    config = json.loads((root / "portbench" / "configs"
                         / f"{cell['config']}.json").read_text())
    mix = load_mix(root, cell)
    kind = load_kind(root, mix)
    mark("import_program")
    arrays = forest_of(config, [seed, drive.FOREST_STREAM])
    spec = from_arrays(arrays)
    prog = Forest(spec, device=dev)
    mark("forest")
    load = kind.Load(config, mix, seed, dev, prog, arrays)
    mark("rows")
    strategy, _ = choose_strategy(spec, load.pick_rows())
    mark("pick")
    load.warm(strategy)
    mark("engine_and_warm_up")
    return Prepared(config, prog, load, strategy, phases)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of ``workload``: the result line as a dict. ``device`` is
    ``cuda`` for a measured run; ``cpu`` runs the same steps on the
    program's plain versions, for the tests."""
    import torch

    from portbench import work
    from portbench.readers import Readings
    from portbench.trace import profile

    bench = load_benchmark(root)
    cell = cell_of(bench, workload)
    dev = torch.device(device)
    check_device(cell, dev)
    t_torch = time.monotonic() - _T0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_device = time.monotonic() - _T0 - t_torch
    metrics = metrics_of(bench, cell, trace)
    readers = {m["name"]: load_file(root, "metrics", m["name"]).read for m in metrics}
    if trace and dev.type != "cuda":
        raise NoResult("a traced run needs a CUDA device")
    p = prepare(root, cell, seed, dev)
    load, strategy, prog, config = p.load, p.strategy, p.prog, p.config
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - _T0
    phases = {"import_torch": t_torch, "device_init": t_device, **p.phases}
    print("set-up, s: " + ", ".join(f"{k} {v!r}" for k, v in phases.items()),
          file=sys.stderr)

    load.window(strategy, seconds)
    summary = None
    if trace:
        summary = profile(lambda span: load.traced(strategy, SLICE_S, span), dev,
                          load.SPANS)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = banned_modules()
    if found:
        raise NoResult(f"modules loaded that the benchmark may not load: {found}")

    # the program's state goes before the reference runs
    prog.drop_engines()
    load.prog = None
    del p, prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = load.judge(work.forest_shape(load.forest))
    if summary is not None:
        print(f"traced slice: {summary.window_s!r} s, device busy "
              f"{summary.busy_s!r} s; device seconds by host span "
              f"{summary.device_s!r}; host spans {summary.spans!r}", file=sys.stderr)
    readings = Readings(setup_s, load, judged, summary)
    values = {}
    for m in metrics:
        v = readers[m["name"]](readings)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = {
        "max_abs_gap": {"value": judged.gap,
                        "limit": float(config["max_abs_gap"])},
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(load.attempted),
        "failed": int(load.failed),
        "metrics": values,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["pick"] = strategy.name
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoResult as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
