"""Training: the card's train step (`training.loop.make_train_step`, a
BufferedTrainStep replayed from a CUDA graph on the card), step after step, as
`training.train` runs it: in float32 with TF32 off (`device.float32_exact`),
the step's draws from the port's own `StepDraws`.

Set-up builds the model with the seed's weights in float32, the train state
(AdamW, the EMA) and the step as `training.train` configures them from the card
(use_fp16, the clip, the keyframe scheme, cuDNN's defaults), and a pool of
motions from the seed. It then drives that same step object through its first
`check.steps` steps, which run it eagerly, capture its graph and replay it,
on rows that all differ, and keeps what the reference follows: the losses,
each leaf's first gradient as AdamW got it, and each leaf's change over those
steps. The window replays the step back to back; train_steps_per_s counts the
steps completed in it (a step's metrics read back on the host) over its length.

The step's draws (keyframe mask, its drop, t, the noise, the condition
dropout) are the port's `StepDraws`, seeded from the run's seed as
`training.train` seeds its own from --seed: a generator on the card and a host
generator for the keyframe masks, which the port draws on the host, item by
item, from the batch's host copy of the lengths. `Recorded` keeps what the
check steps drew for the reference.

Traffic keys: batch, frames (the card's num_frames), lengths ([lo, hi]),
pool (rows in the pool), use_fp16 (as the configuration states it),
trace_slice_steps, probe_replays, check ({steps, limits}).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark.core import census, program, timing
from benchmark.core.seeds import derive
from benchmark.core.trace import Slice


def _recorded_draws(seed: int, device, keep_steps: int):
    """The port's StepDraws, seeded from `seed`, keeping every draw of the first
    `keep_steps` steps (each step opened by `begin`)."""
    from condmdi_tpu_torch.training.loop import StepDraws

    class Recorded(StepDraws):
        def __init__(self):
            super().__init__(torch.Generator(device=device).manual_seed(derive(seed, "train draws")),
                             torch.Generator().manual_seed(derive(seed, "train keyframes")))
            self.step, self.kept = 0, []

        def begin(self, step: int):
            self.step = step
            if step <= keep_steps:
                self.kept.append({"keep": []})

        def _keep(self, name, value):
            if self.step <= keep_steps:
                if name == "keep":
                    self.kept[-1]["keep"].append(value.clone())
                else:
                    self.kept[-1][name] = value.clone()
            return value

        def keyframe_mask(self, lengths, T, scheme):
            return self._keep("mask", super().keyframe_mask(lengths, T, scheme))

        def keyframe_drop(self, B, prob, device):
            return self._keep("drop", super().keyframe_drop(B, prob, device))

        def timesteps(self, loss_aware, B, num_timesteps, device):
            t, w = super().timesteps(loss_aware, B, num_timesteps, device)
            return self._keep("t", t), w

        def noise(self, shape, dtype, device):
            return self._keep("noise", super().noise(shape, dtype, device))

        def model(self):
            inner, outer = super().model(), self

            class Kept:
                def keep(self, shape, keep_prob, device):
                    return outer._keep("keep", inner.keep(shape, keep_prob, device))

            return Kept()

    return Recorded()


def train_config(args):
    """The TrainConfig training.train builds from the card's arguments."""
    from condmdi_tpu_torch.training.loop import TrainConfig

    return TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, adam_beta2=args.adam_beta2,
        grad_clip=args.grad_clip, avg_model_beta=args.avg_model_beta,
        lr_anneal_steps=args.lr_anneal_steps, num_steps=args.num_steps,
        batch_size=args.batch_size, schedule_sampler="uniform",
        keyframe_conditioned=args.keyframe_conditioned,
        keyframe_selection_scheme=args.keyframe_selection_scheme,
        keyframe_mask_prob=args.keyframe_mask_prob, zero_keyframe_loss=args.zero_keyframe_loss,
        use_bf16=args.use_fp16)


def _exact():
    """Float32 with TF32 off, as `training.train` runs (its `main` under float32_exact)."""
    from condmdi_tpu_torch.device import float32_exact

    return float32_exact()


class Session:
    def __init__(self, run):
        self.run, self.tr, self.cfg = run, run.cell.traffic, run.cell.config

    # ------------------------------------------------------------------ data
    def _pool(self):
        tr, cfg, dev = self.tr, self.cfg, self.run.device
        n, T, F = tr["pool"], tr["frames"], cfg["njoints"]
        rng = np.random.default_rng(derive(self.run.seed, "train lengths"))
        lo, hi = tr["lengths"]
        lengths = rng.permutation(np.linspace(lo, hi, n).round().astype(np.int64))
        g = torch.Generator(device=dev).manual_seed(derive(self.run.seed, "train motions"))
        motion = torch.randn((n, T, F), generator=g, device=dev)
        lengths_t = torch.as_tensor(lengths, device=dev)
        time_mask = torch.arange(T, device=dev)[None] < lengths_t[:, None]
        motion *= time_mask[..., None]
        text = torch.randn((n, 512), generator=g, device=dev)
        self.pool = {"motion": motion, "time_mask": time_mask, "lengths": lengths_t,
                     "lengths_host": torch.as_tensor(lengths), "text_embed": text}

    def batch(self, k: int) -> dict:
        """Batch k: the pool's rows k·B … k·B + B − 1, cyclically."""
        B, n = self.tr["batch"], self.tr["pool"]
        # the rows made where each tensor lives: no copy, so no wait for the card
        return {key: v[(torch.arange(B, device=v.device) + k * B) % n]
                for key, v in self.pool.items()}

    # ------------------------------------------------------------------ set-up
    def setup(self):
        with _exact():
            self._setup()

    def _setup(self):
        from condmdi_tpu_torch.training.loop import create_train_state, make_train_step

        run, tr, cfg = self.run, self.tr, self.cfg
        split = run.obs.setdefault("setup_split", {})
        t = time.perf_counter()
        self.model, sched, dcfg, args = program.build(cfg, run.seed, run.device, "f32", train=True)
        sched = sched.to(run.device)
        self.args = args
        self.tcfg = train_config(args)
        if self.tcfg.use_bf16 != tr["use_fp16"]:
            raise SystemExit(f"the card trains with use_fp16={self.tcfg.use_bf16}; the cell "
                             f"states {tr['use_fp16']}")
        self.state = create_train_state(self.model, self.tcfg, sched)
        self.step = make_train_step(self.model, sched, dcfg, self.tcfg)
        self._pool()
        n_check = tr["check"]["steps"]
        self.draws = _recorded_draws(run.seed, run.device, n_check)
        self.k = 0
        self.losses = []
        split["model, weights, state and data"] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(n_check):
            self.losses.append(self._one())
            if self.k == 1:  # AdamW's first moment after one step is (1 - b1) g
                st = self.state.optimizer.state
                self.first_norms = [float(st[p]["exp_avg"].norm()) / 0.1 if p in st else 0.0
                                    for p in self.state.params.values()]
        self.losses = [float(v) for v in self.losses]
        split[f"first {n_check} steps (eager, capture, replay)"] = time.perf_counter() - t
        self.changes = self._changes()
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    def _one(self):
        self.k += 1
        self.draws.begin(self.k)
        return self.step(self.state, self.batch(self.k - 1), self.draws)["loss"]

    # ------------------------------------------------------------------ window
    def window(self):
        with _exact():
            self._window()

    def _window(self):
        run, tr = self.run, self.tr
        trace = Slice() if run.trace else None
        done, t0 = 0, time.perf_counter()
        end = t0 + run.seconds
        last = None
        while True:
            if trace is not None and trace.t1 is None and not trace.running \
                    and time.perf_counter() - t0 >= run.seconds / 3.0:
                torch.cuda.synchronize()
                trace.start()
                traced_from = done
            last = self._one()
            done += 1
            if trace is not None and trace.running and done - traced_from >= tr["trace_slice_steps"]:
                trace.stop()
            if time.perf_counter() >= end:
                break
        float(last)  # the last step's loss on the host: every step has run
        t1 = time.perf_counter()
        # steps completed in the window: the last step, which ends past it, counted
        # by the share of it that fell inside
        per = (t1 - t0) / done
        inside = done - max(0.0, (t1 - end) / per)
        run.attempted, run.failed = done, 0
        run.e2e["train_steps_per_s"] = inside / run.seconds
        if trace is not None and trace.summary is not None:
            run.obs["trace"] = trace.summary

    def _changes(self):
        w0 = program.make_weights(self.cfg, self.run.seed, self.run.device, "f32")
        return [float((p.detach() - w0[n]).norm()) for n, p in self.state.params.items()]

    # ------------------------------------------------------------------ per-layer probes
    def probe(self):
        with _exact():
            self._probe()

    def _probe(self):
        from benchmark.counts import models

        run, tr, cfg = self.run, self.tr, self.cfg
        graph = self.step.graph
        ms = timing.replay_ms(lambda: graph(check=False), n=tr["probe_replays"], reps=3)
        run.obs["step"] = {"device_ms": ms, "dtype": "f32",
                           "flops": 3 * models.forward(cfg, tr["batch"], tr["frames"])}
        batch = self.batch(0)

        def forward():
            x = batch["motion"].to(torch.bfloat16).requires_grad_(False)
            out = self.model(x, torch.full((tr["batch"],), 500, device=run.device),
                             {"text_embed": batch["text_embed"]},
                             obs_x0=batch["motion"].to(torch.bfloat16),
                             obs_mask=batch["time_mask"][..., None].expand_as(batch["motion"]))
            out.float().sum().backward()

        calls = census.census(self.model, forward)
        self.model.zero_grad(set_to_none=True)
        run.obs["calls"] = census.time_calls(calls, run.device, backward=True,
                                             seed=run.seed % 2**31)

    # ------------------------------------------------------------------ release and check
    def release(self):
        self.kept = self.draws.kept
        self.batches = [self.batch(k) for k in range(self.tr["check"]["steps"])]
        del self.step, self.state, self.model, self.pool
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32", loss_fn=None):
        """The reference's (losses, first gradient norms, changes) over the check
        steps' batches and draws, its products at `precision`."""
        from benchmark.reference.precision import Precision
        from benchmark.reference.train import train_steps

        run, tr, cfg = self.run, self.tr, self.cfg
        w0 = program.make_weights(cfg, run.seed, run.device, "f32")
        tc = {"lr": self.tcfg.lr, "weight_decay": self.tcfg.weight_decay,
              "adam_beta2": self.tcfg.adam_beta2, "grad_clip": self.tcfg.grad_clip,
              "use_fp16": tr["use_fp16"]}
        dev = run.device
        draws = [{"t": d["t"].to(dev), "noise": d["noise"].to(dev),
                  "mask": None if d.get("mask") is None else d["mask"].to(dev),
                  "drop": None if d.get("drop") is None else d["drop"].to(dev),
                  "keep": d["keep"][0].to(dev)} for d in self.kept]
        return train_steps(w0, cfg, tc, self.batches, draws, Precision(precision),
                           **({} if loss_fn is None else {"loss_fn": loss_fn}))[:3]

    def check(self):
        return compare(self.losses, self.first_norms, self.changes, *self.reference(),
                       self.tr["check"]["limits"])


def _leaf_gap(got, want):
    """The worst leaf's |got − want| over the larger of the reference's norm of that
    leaf and the median leaf's norm."""
    med = statistics.median(want)
    return max(abs(g - w) / max(w, med, 1e-30) for g, w in zip(got, want))


def compare(losses, norms, change, ref_losses, ref_norms, ref_change, limits):
    """The compared numbers. A leaf whose first gradient in the reference is under a
    thousandth of the median leaf's moves under AdamW by round-off alone, and is
    left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    floor = 1e-3 * statistics.median(ref_norms)
    moved = [i for i, n in enumerate(ref_norms) if n >= floor]
    change_gap = _leaf_gap([change[i] for i in moved], [ref_change[i] for i in moved])
    return [("loss_rel_gap_max", loss_gap, limits["loss"]),
            ("first_grad_leaf_gap_max", _leaf_gap(norms, ref_norms), limits["grad"]),
            ("param_change_leaf_gap_max", change_gap, limits["change"])]
