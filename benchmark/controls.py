"""Readings of the controls of `correct`, at a cell's own size (not part of a run).

    python3 benchmark/controls.py --workload <name> --seeds 11,12,13 [--requests k]
        [--program] [--fault]

For each seed it makes the cell's weights and inputs as a run does and prints
one JSON line for each reading, with the numbers a run compares and the
`correct` that a run's rule (every number within its committed limit) gives
them: the control, the reference at the next precision below the
configuration's put in the program's place (fp8 e4m3 for the bfloat16 serving
cells, TF32 for the float32 cells with TF32 off), against the reference at the
stated precision. For the training cell, `--program` also reads the program's
own check steps (the set-up of a run, without its window) and the bfloat16
reading, and `--fault` the fault "half of the batch left out, the mean taken
over the rest", planted in the reference put in the program's place.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROL = {"bf16": "fp8", "f32": "tf32"}


def reading(kind: str, checks) -> dict:
    """The numbers under their limits and the run's rule over them."""
    return {"reading": kind, **{n: v for n, v, _ in checks},
            "limits": {n: lim for n, _, lim in checks},
            "correct": all(math.isfinite(v) and v <= lim for _, v, lim in checks)}


def serve_control(cell, seed, device, k):
    import torch

    from benchmark.core import sampled, serving

    tr, cfg = cell.traffic, cell.config
    bucket = tr.get("max_batch", tr.get("batch"))
    reqs = serving.requests(bucket, cfg["frames"], cfg["njoints"], seed, tr.get("keyframes"))
    first = reqs[0]["noise_seed"]
    placed = [sampled.Placed(first, bucket, i, torch.from_numpy(r["text"]),
                             torch.from_numpy(r["obs_x0"]) if "obs_x0" in r else None,
                             torch.from_numpy(r["obs_mask"]) if "obs_mask" in r else None)
              for i, r in enumerate(reqs[:k])]
    want = sampled.reference_motions(cfg, seed, tr["precision"], placed, tr["guidance"], device)
    control = CONTROL[tr["precision"]]
    got = sampled.reference_motions(cfg, seed, tr["precision"], placed, tr["guidance"], device,
                                    precision=control)
    worst = float(sampled.rel_rms(got, want).max())
    return [reading(f"control {control}", [("motion_rel_rms_max", worst, tr["check"]["limit"])])]


def train_readings(cell, seed, device, program=False, fault=False):
    """The training cell's readings for one seed: the check steps run by the
    program as a run's set-up runs them, followed by the reference."""
    import gc

    import torch

    from benchmark import run as bench_run
    from benchmark.core import spec

    drv = spec.driver("train_steps")
    limits = cell.traffic["check"]["limits"]
    s = drv.Session(bench_run.Run(cell, seed, 0.0, False, torch.device(device)))
    s.setup()
    s.release()
    gc.collect()
    torch.cuda.empty_cache()
    want = s.reference()
    out = []
    if program:
        out.append(reading("program", drv.compare(s.losses, s.first_norms, s.changes, *want,
                                                  limits)))
    for prec in ("tf32", "bf16") if program else ("tf32",):
        out.append(reading(f"control {prec}", drv.compare(*s.reference(prec), *want, limits)))
    if fault:
        from benchmark.reference import train as ref_train

        def half(model, sched, batch, dr):
            B = batch["motion"].shape[0] // 2
            return ref_train.loss_fn(model, sched, {k: v[:B] for k, v in batch.items()},
                                     {k: None if v is None else v[:B] for k, v in dr.items()})

        out.append(reading("fault half_batch",
                           drv.compare(*s.reference(loss_fn=half), *want, limits)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=0)
    p.add_argument("--program", action="store_true",
                   help="training: the program's own readings and the bfloat16 one too")
    p.add_argument("--fault", action="store_true", help="training: the half-batch fault")
    a = p.parse_args(argv)
    from benchmark import run as bench_run
    from benchmark.core import spec

    bench_run.environment(ROOT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["driver"] == "train_steps":
            out = train_readings(cell, seed, "cuda", a.program, a.fault)
        else:
            k = a.requests or cell.traffic["check"]["requests"]
            out = serve_control(cell, seed, "cuda", k)
        for r in out:
            print(json.dumps({"workload": a.workload, "seed": seed, **r,
                              "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
