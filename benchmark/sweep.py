"""Find a serving cell's knee: the highest offered rate with no growing backlog.

    python3 benchmark/sweep.py --workload <name> --rates 1.4,1.7,2.0 --seconds 40 --seed 1

One process builds and warms the cell once, then offers each rate in turn for
--seconds (the cell's own generator, open loop) and drains. For each rate it
prints one JSON line: the requests sent, the median and 90th-percentile
latency, the mean batch fill, and the backlog's trend, the median latency of
the window's last quarter of requests over its first quarter's (about 1 where
the queue is steady, growing with the window where it is not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    import torch

    from benchmark.core import readers, serving, spec, stats
    from benchmark.run import Run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell(bench, a.workload)
    run = Run(cell, a.seed, a.seconds, False, torch.device("cuda"))
    session = spec.driver(cell.traffic["driver"]).Session(run)
    t0 = time.perf_counter()
    session.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate in (float(r) for r in a.rates.split(",")):
        session.tr = dict(cell.traffic, rate_per_s=rate)
        session.times = serving.arrivals(rate, a.seconds, a.seed)
        session.reqs = serving.requests(len(session.times), cell.config["frames"],
                                        cell.config["njoints"], a.seed,
                                        cell.traffic.get("keyframes"))
        session.server.batches.clear()
        run.obs.clear()
        session.window()
        lat = run.obs["latencies"]
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "workload": a.workload, "rate_per_s": rate, "sent": len(lat), "failed": run.failed,
            "p50_s": stats.median(lat), "p90_s": stats.percentile(lat, 90.0),
            "batch_fill_pct": readers.batch_fill(run.obs),
            "trend": stats.median(lat[-q:]) / stats.median(lat[:q]),
            "batches": len(run.obs["batches"])}), flush=True)
    session.release()


if __name__ == "__main__":
    main()
