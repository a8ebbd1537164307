"""Train the committed gate configuration on the card and set its loss beside the TPU run's.

    python3 train_curve.py

Trains, through condmdi_tpu_torch.training.train.main, the configuration in
save/synthetic_unet_m/args.json (the keyframe UNet at latent 128, dim_mults
1 2 2, the synthetic set of 4,096 items, batch 64, seed 10, use_fp16, the
device data cache re-collated every 1,000 steps, 200 steps a dispatch) for
2,000 steps, and reads its progress.csv row at step 2,000 (the mean over
steps 1,801-2,000, as the chained loop logs it) beside the committed TPU
run's row at that step (save/synthetic_unet_m/progress.csv: loss 0.6045,
loss_q0-q3 0.557 / 0.569 / 0.598 / 0.690).

The two runs draw their noise, timesteps and keyframe masks from different
generators (jax.random there, torch here), so the rows are not expected to be
equal. The band is taken from the committed curve itself: the change of each
value between its logged rows at steps 2,000 and 4,000 (a 2,000-step shift in
progress); the late, flat part of the curve (steps >= 60,000) gives the row
noise, printed beside it. A value inside its band is "within", outside
"outside": a finding, not a gate. The script fails only if training does not
run or gives a non-finite loss.

Prints steps/s (the steps after the first row, which holds the start-up, over
their host wall time) beside the card's name and power limit; then where one
step's time goes: its host clock against its device time over 5 steps, the
launches a step, and the kernels and host-side operators that take the most
(torch.profiler), in full float32 as the training ran (TF32 off: `main` turns it
off only while it runs). The last line is one JSON object with the numbers. Outputs
go to chiprun_out/train_curve/ (the checkpoints are deleted after the run).
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GATE = ROOT / "save" / "synthetic_unet_m"
OUT = ROOT / "chiprun_out" / "train_curve"
STEPS = 2000
KEYS = ("loss", "loss_q0", "loss_q1", "loss_q2", "loss_q3")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def rows_of(path: Path) -> list[dict]:
    """progress.csv rows as floats (the logger pads earlier rows with empty cells)."""
    with open(path) as f:
        return [{k: float(v) for k, v in r.items() if k and v not in ("", None)}
                for r in csv.DictReader(f)]


def committed_run() -> list[dict]:
    """The committed file's first run: its rows up to the first step that goes back."""
    rows, run = rows_of(GATE / "progress.csv"), []
    for r in rows:
        if run and r["step"] <= run[-1]["step"]:
            break
        run.append(r)
    return run


def argv_from_args_json(path: Path) -> list[str]:
    argv = []
    for key, value in json.loads(path.read_text()).items():
        if value is None:
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        argv.append(f"--{key}")
        argv.extend(str(v) for v in value) if isinstance(value, list) else argv.append(str(value))
    return argv


def profile_steps(loop, steps=5, top=8) -> dict:
    """One train step of `loop` on a batch gathered from its device cache: host ms
    (the wall clock over `steps` steps, synchronised) against device ms, launches a
    step, and the largest kernels and host-side operators (torch.profiler)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data, n = loop.device_data
    batch = loop._gather(data, np.arange(loop.args.batch_size) % n)
    loop.step_fn(loop.state, batch, loop.draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loop.step_fn(loop.state, batch, loop.draws)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            loop.step_fn(loop.state, batch, loop.draws)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def self_time(e, device):
        name = "self_device_time_total" if device else "self_cpu_time_total"
        return getattr(e, name, getattr(e, "self_cuda_time_total", 0.0) if device else 0.0)

    kernels = sorted(((e.key, self_time(e, True), e.count) for e in events
                      if e.device_type == DeviceType.CUDA and self_time(e, True) > 0),
                     key=lambda r: -r[1])
    ops = sorted(((e.key, self_time(e, False), e.count) for e in events
                  if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels) / steps / 1e3
    launches = sum(r[2] for r in kernels) // steps
    print(f"[train_curve] one step: {host_ms:.2f} ms on the host clock, "
          + (f"{device_ms:.2f} ms of device time in {launches} launches (idle "
             f"{1 - device_ms / host_ms:.1%})" if kernels else "device time not measured"))
    for name, us, count in kernels[:top]:
        print(f"[train_curve]   device {us / steps / 1e3:8.3f} ms {count // steps:5d} x {name[:90]}")
    for name, us, count in ops[:top]:
        print(f"[train_curve]   host   {us / steps / 1e3:8.3f} ms {count // steps:5d} x {name[:90]}")
    return dict(host_ms=host_ms, device_ms=device_ms if kernels else None, launches=launches,
                kernels=[dict(name=k[:90], ms=us / steps / 1e3) for k, us, _ in kernels[:top]],
                host_ops=[dict(name=k[:90], ms=us / steps / 1e3) for k, us, _ in ops[:top]])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_curve: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from condmdi_tpu_torch.device import float32_exact
    from condmdi_tpu_torch.training import train

    card = card_line()
    ref = committed_run()
    at = {r["step"]: r for r in ref}
    ref_row, next_row = at[float(STEPS)], at[float(2 * STEPS)]
    late = [r for r in ref if r["step"] >= 60000]
    band = {k: abs(next_row[k] - ref_row[k]) for k in KEYS}
    noise = {k: statistics.pstdev(np.diff([r[k] for r in late])) / 2 ** 0.5 for k in KEYS}

    os.environ.setdefault("CONDMDI_SYNTH_CACHE", str(ROOT / ".chipwork" / "synth_cache"))
    argv = argv_from_args_json(GATE / "args.json") + [
        "--num_steps", str(STEPS), "--save_interval", str(STEPS), "--log_interval", "200",
        "--save_dir", str(OUT), "--overwrite", "true", "--text_encoder", "hash"]
    t0 = time.perf_counter()
    loop = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with float32_exact():  # as training ran: main turns TF32 off while it runs, and back on
        step = profile_steps(loop)
    for f in list(OUT.glob("ckpt_*.pth")) + list(OUT.glob("ema_*.npz")):
        f.unlink()
    rows = rows_of(OUT / "progress.csv")
    got = next(r for r in rows if r["step"] == STEPS)
    # the steps after the first row over their host wall time (each row's interval is its
    # steps over its logged rate), so that a stall counts
    steps = [r["step"] - q["step"] for q, r in zip(rows, rows[1:])]
    rate = sum(steps) / sum(n / r["steps_per_sec"] for n, r in zip(steps, rows[1:]))
    if not all(np.isfinite(got[k]) for k in KEYS):
        print(f"train_curve: non-finite losses at step {STEPS}: {got}", file=sys.stderr)
        return 1
    print(f"[train_curve] the gate configuration, {STEPS} steps on {card}: {rate:.2f} steps/s "
          f"(the steps after the first row over their host time), {seconds:.1f} s in all")
    result = {}
    for k in KEYS:
        d = got[k] - ref_row[k]
        verdict = "within" if abs(d) <= band[k] else "outside"
        result[k] = dict(port=got[k], tpu=ref_row[k], diff=d, band=band[k], row_noise=noise[k],
                         verdict=verdict)
        print(f"[train_curve] {k} at step {STEPS}: port {got[k]:.4f}, committed TPU run "
              f"{ref_row[k]:.4f}, diff {d:+.4f}; band +-{band[k]:.4f} (the committed change "
              f"from step {STEPS} to {2 * STEPS}), row noise {noise[k]:.4f}: {verdict}")
    print(card)
    print(json.dumps({"card": card, "steps": STEPS, "steps_per_sec": rate, "seconds": seconds,
                      "step": step, "rows": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
