"""Whether a data-parallel train step's NCCL collectives survive capture in a CUDA graph.

    python3 graph_nccl_probe.py [N]

On one NVIDIA GPU. It prints the card's name and power limit first. It stands
beside chip_smoke.py, whose model, batch and helpers it uses; nothing in the
package or in chip_smoke.py needs it.

The package replays a data-parallel train step as two graphs with the
all-reduce between them, on the host; this probe captures the step the other
way, as one graph with its collectives inside it. It runs the data-parallel
UNet-XL train step of chip_smoke.py phase 39 (B=8, keyframe-conditioned, a
one-rank NCCL group) N times (default 16), each one a fresh capture: the eager
first step, the second (an eager warm-up, then the capture with the step's
all-reduce and all-gathers inside it) and one replay. Each variant runs in a
process of its own, since some set the environment before the process group is
made:

  base       the default environment;
  aeh0       TORCH_NCCL_ASYNC_ERROR_HANDLING=0;
  nomix      NCCL_GRAPH_MIXING_SUPPORT=0;
  noevcache  TORCH_NCCL_CUDA_EVENT_CACHE=0;
  settle     the card synchronised and 0.3 s waited before each capture begins
             (the process group's watchdog finds the warm-up's collectives done);
  gcoff      Python's garbage collector off while a capture runs.

Each variant's failures and their first error lines, and the process's native
threads, go to standard output and to chiprun_out/graph_nccl_probe.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VARIANTS = {
    "base": {},
    "aeh0": {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"},
    "nomix": {"NCCL_GRAPH_MIXING_SUPPORT": "0"},
    "noevcache": {"TORCH_NCCL_CUDA_EVENT_CACHE": "0"},
    "settle": {},
    "gcoff": {},
}


def threads() -> list[str]:
    """The names of this process's native threads."""
    names = []
    for task in sorted(Path("/proc/self/task").iterdir()):
        try:
            names.append((task / "comm").read_text().strip())
        except OSError:
            pass
    return names


def child(variant: str, n: int) -> dict:
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset, collate
    from condmdi_tpu_torch.diffusion import DiffusionConfig
    from condmdi_tpu_torch.models.text import HashTextEncoder
    from condmdi_tpu_torch.models.unet import MDM_UNET
    from condmdi_tpu_torch.parallel import initialize_distributed, make_mesh
    from condmdi_tpu_torch.training.loop import (BufferedTrainStep, StepDraws, TrainConfig,
                                                 _step_body, create_train_state)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graph_cls = torch.cuda.graphs.CUDAGraph
    begin, end = graph_cls.capture_begin, graph_cls.capture_end
    if variant == "settle":
        def capture_begin(self, *a, **k):
            torch.cuda.synchronize()
            time.sleep(0.3)
            return begin(self, *a, **k)
        graph_cls.capture_begin = capture_begin
    elif variant == "gcoff":
        def capture_begin(self, *a, **k):
            gc.disable()
            return begin(self, *a, **k)

        def capture_end(self, *a, **k):
            try:
                return end(self, *a, **k)
            finally:
                gc.enable()
        graph_cls.capture_begin, graph_cls.capture_end = capture_begin, capture_end

    dev = torch.device("cuda")
    initialize_distributed(init_method=f"tcp://localhost:{cs.free_port()}", world_size=1,
                           rank=0, backend="nccl")
    mesh = make_mesh()
    B = 8
    rel = SyntheticMotionDataset(DatasetConfig(max_motion_length=cs.T_FRAMES, abs_3d=False),
                                 size=B, seed=1, device=dev)
    np.random.seed(0)
    batch = collate([rel[i] for i in range(B)], cs.T_FRAMES, HashTextEncoder())
    tb = {"motion": torch.from_numpy(batch["motion"]).to(dev),
          "time_mask": torch.from_numpy(batch["time_mask"]).to(dev),
          "lengths": torch.from_numpy(batch["lengths"]).long().to(dev),
          "lengths_host": torch.from_numpy(batch["lengths"]).long(),
          "text_embed": torch.from_numpy(batch["text_embed"]).to(dev)}
    sched = cs.schedule(1000).to(dev)
    tcfg = TrainConfig(lr=1e-4, keyframe_conditioned=True)
    net = MDM_UNET(**cs.XL, zero=False, device=dev, seed=0).train()
    state = create_train_state(net, tcfg, sched)
    draws = StepDraws(torch.Generator(dev).manual_seed(5), torch.Generator().manual_seed(6))
    errors = []
    t0 = time.perf_counter()
    for _ in range(n):
        body = _step_body(net, sched, DiffusionConfig(), tcfg, mesh)
        step = BufferedTrainStep(net, sched, tcfg, body)
        step.mesh = None  # one graph of the whole body, its collectives inside it
        try:
            for _ in range(3):
                loss = step(state, tb, draws)["loss"]
            torch.cuda.synchronize()
            errors.append(None if bool(torch.isfinite(loss)) else "non-finite loss")
        except Exception as e:  # noqa: BLE001 - the probe counts the failures
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            errors.append(f"{type(e).__name__}: {' | '.join(lines[:3])}"[:400])
            try:
                torch.cuda.synchronize()
            except Exception:  # noqa: BLE001
                pass
        del step, body
    seconds = time.perf_counter() - t0
    out = {"variant": variant, "env": VARIANTS[variant], "captures": n,
           "failures": sum(e is not None for e in errors), "errors": errors,
           "seconds": seconds, "threads": threads(), "torch": torch.__version__,
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    torch.distributed.destroy_process_group()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_nccl_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(f"[probe] {cs.card_line()}; torch {torch.__version__}", flush=True)
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        variant, n = sys.argv[2], int(sys.argv[3])
        print("RESULT " + json.dumps(child(variant, n)), flush=True)
        return 0
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    cs.build_kernels()
    results = []
    for variant, env in VARIANTS.items():
        proc = subprocess.run([sys.executable, __file__, "--child", variant, str(n)],
                              env=dict(os.environ, **env), cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        found = [ln[7:] for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        res = json.loads(found[0]) if found else {"variant": variant, "rc": proc.returncode,
                                                  "stderr": proc.stderr[-3000:]}
        results.append(res)
        print(f"[probe] {variant}: {res.get('failures')} of {res.get('captures')} captures "
              f"failed in {res.get('seconds', 0):.1f} s; "
              f"{sorted(set(e for e in res.get('errors', []) if e))[:3] or res.get('stderr', '')[-800:]}",
              flush=True)
    print(f"[probe] threads: {results[0].get('threads')}; nccl {results[0].get('nccl')}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "graph_nccl_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
