"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, benchmark/ and the port
(condmdi_tpu_torch). The cell's configuration, traffic and driver are found by
the names BENCHMARK.json gives them. The run builds and warms the program
(set-up), measures for --seconds, drains, reads the peak memory, with --trace 1
takes the per-layer readings, frees the program, and compares what the timed
path produced with the plain reference. Standard output's last line is the
result; standard error's last lines are each compared number beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

RUN_LIMIT_S = 345  # a run must end within 360 s
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class Run:
    """What a driver reads and fills."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    e2e: dict = field(default_factory=dict)
    obs: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def environment(root: Path) -> None:
    """Caches at fixed places inside the checkout; few host threads."""
    cache = root / ".benchcache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
            root: Path = BENCH_DIR, t_start: float = T_PROCESS) -> dict:
    """One run of cell `name` on `device`; returns the result (the printed line's
    object, with the compared numbers under "checks")."""
    import torch

    from benchmark.core import isolation, spec

    cell = spec.load_cell(bench, name, root)
    run = Run(cell, seed, float(seconds), bool(trace), torch.device(device))
    session = spec.driver(cell.traffic["driver"], root).Session(run)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    session.setup()
    if cuda:
        torch.cuda.synchronize(run.device)
    marks = [("setup", time.perf_counter())]
    setup_s = marks[0][1] - t_start
    session.window()
    marks.append(("window and drain", time.perf_counter()))
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if trace:
        session.probe()
        marks.append(("per-layer probes", time.perf_counter()))
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = session.check()
    marks.append(("reference check", time.perf_counter()))
    from condmdi_tpu_torch.ops import _build

    split = dict(run.obs.get("setup_split", {}))
    split.update({f"nvcc {k}": v for k, v in _build.build_seconds.items()})
    print(f"{name}: set-up split " + "; ".join(f"{k} {v:.2f} s" for k, v in split.items()),
          file=sys.stderr)
    if "sender_late_max_s" in run.obs:
        print(f"{name}: the sender ran at most {run.obs['sender_late_max_s']:.4f} s late",
              file=sys.stderr)
    print(f"{name}: set-up {setup_s:.2f} s; " + "; ".join(
        f"{label} {b - a:.2f} s" for (_, a), (label, b) in zip(marks, marks[1:])),
        file=sys.stderr)
    found = isolation.forbidden_modules()
    if found:
        fail(f"the measured process holds {', '.join(found)}: it must not load JAX, Flax or "
             f"the JAX package", 3)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], root).read(run.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else run.device.type,
           "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": int(cell.entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and "trace" in run.obs:
        tr = run.obs["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["correct"] = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    result["checks"] = {n: {"value": v, "limit": limit} for n, v, limit in checks}
    return result


def finite(obj):
    """The result with every infinite or NaN number as null (a run whose numbers
    are not finite is not correct)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        fail(f"{bench_file} is missing")
    bench = json.loads(bench_file.read_text())
    environment(ROOT)
    import torch

    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == a.workload), None)
    if chips is None:
        fail(f"no workload named {a.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"{a.workload} needs {chips} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import condmdi_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the program under test, condmdi_tpu_torch, is not in this checkout: {exc}")
    torch.set_num_threads(4)
    # a run that has not ended by then prints every thread's stack and exits non-zero
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    result = execute(bench, a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    result = finite(result)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
