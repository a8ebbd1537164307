"""Training entry point: the host loop around training/loop.py's step.

Counterpart of condmdi_tpu/training/train.py (`TrainLoop`, `main`). Usage:

  python -m condmdi_tpu_torch.training.train --config motion_abs_unet_adagn_xl \
      --keyframe_conditioned true [--save_dir save/exp] [--num_steps N]

Runs on the card in full float32 (no TF32, `device.float32_exact`), or on the
CPU with `main(argv, device="cpu")`; raises without a card. The model starts
from Flax's initialisation at --seed (the JAX package's weights for the same
seed). This module owns:

  * the data feed: batches streamed from the host loader through a prefetch
    thread, or, with --device_data_cache (true, or auto for a set that draws
    no randomness per item and is under 1 GiB), the collated set kept on the
    card and batches gathered there by index, re-collated every
    --device_cache_refresh steps; the indices come from the JAX package's
    numpy stream, default_rng(seed + 17 + 1009 * process_index);
  * --steps_per_dispatch K (with the device cache): K steps per host
    iteration on batches gathered on the card, [K, B] indices drawn at once,
    logging and saving on the JAX loop's boundaries, and the remainder of
    num_steps single-step on a fresh index stream, as JAX runs its tail; on
    the card each step is a replay of the train step's CUDA graph
    (training/loop.py `BufferedTrainStep`), so K replays go between two host
    boundaries, the counterpart of JAX's `lax.scan` over K steps;
  * logging (utils/logger.py: log.txt, progress.csv) every --log_interval
    steps;
  * checkpoints every --save_interval steps and at the end
    (utils/checkpoint.py: a resume file and the EMA as a flat Flax npz that
    the CLIs and evals.run read), auto-resume from the newest, --overwrite to
    start afresh, args.json;
  * the DIFFUSION_TRAINING_TEST hook (stop after the first save), and
    --eval_during_training through the port's evals.run on the EMA npz.

Resume is exact: the checkpoint holds the parameters, the optimizer's
moments and count, the EMA, the step's generators and the data stream's
position (the loader's epoch and batch, the numpy streams' states); a
streamed feed restarts its prefetch thread at every save, so a resumed run
and a straight one read the same batches.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact, resolve_device
from condmdi_tpu_torch.utils.seed import seed_all

_CACHE_AUTO_CAP = 1 << 30  # --device_data_cache auto keeps sets up to 1 GiB on the card


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The collated numpy batch as tensors on `device` (captions and tokens dropped)."""
    out = {}
    for k, v in batch.items():
        if k in ("text", "tokens"):
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if k in ("lengths", "action") else t).to(device, non_blocking=True)
    return out


class _IndexStream:
    """Batch indices into the device cache from the JAX package's numpy stream."""

    def __init__(self, seed: int, process_index: int):
        self.rng = np.random.default_rng(seed + 17 + 1009 * process_index)

    def state(self):
        return self.rng.bit_generator.state

    def load_state(self, state) -> None:
        self.rng.bit_generator.state = state


class TrainLoop:
    """The host loop. `cuda_graphs=False` runs every step eagerly on the card (for
    comparison with the graph-replayed step, training/loop.py).

    `mesh`: a data-parallel DeviceMesh (parallel/mesh.py), the counterpart of the
    JAX TrainLoop's mesh. Each rank's loader yields its B/n rows (its shard of
    the data, `process_index` = rank), the step all-reduces the gradients
    (training/loop.py `make_train_step`), and rank r > 0 logs and keeps its own
    resume checkpoints under <save_dir>/rank<r>/, so that every rank resumes its
    own data stream; rank 0's save_dir holds the EMA npz the CLIs read."""

    def __init__(self, args, model, sched, dcfg, data_loader, device, cuda_graphs: bool = True,
                 mesh=None):
        from condmdi_tpu_torch.training.loop import (
            StepDraws,
            TrainConfig,
            create_train_state,
            make_train_step,
        )
        from condmdi_tpu_torch.utils import checkpoint as ckpt
        from condmdi_tpu_torch.utils import logger

        self.args = args
        self.model = model
        self.device = device
        self.data_loader = data_loader
        self.save_dir = Path(args.save_dir or "save/condmdi_run")
        self.mesh = mesh
        self.batch_size = args.batch_size  # this process's rows of a step's batch
        if mesh is not None:
            self.batch_size = args.batch_size // mesh.size()
            if mesh.get_local_rank() > 0:
                self.save_dir = self.save_dir / f"rank{mesh.get_local_rank()}"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.logger = logger
        logger.configure(str(self.save_dir), log_suffix="")

        self.tcfg = TrainConfig(
            lr=args.lr, weight_decay=args.weight_decay, adam_beta2=args.adam_beta2,
            grad_clip=args.grad_clip, avg_model_beta=args.avg_model_beta,
            lr_anneal_steps=args.lr_anneal_steps, num_steps=args.num_steps,
            batch_size=args.batch_size, log_interval=args.log_interval,
            save_interval=args.save_interval,
            schedule_sampler=getattr(args, "schedule_sampler", "uniform"),
            keyframe_conditioned=args.keyframe_conditioned,
            keyframe_selection_scheme=args.keyframe_selection_scheme,
            keyframe_mask_prob=args.keyframe_mask_prob,
            zero_keyframe_loss=args.zero_keyframe_loss,
            use_bf16=args.use_fp16,  # the legacy flag's name: bf16 activations
            remat=getattr(args, "remat", False),
        )
        self.sched, self.dcfg = sched, dcfg
        self.state = create_train_state(model, self.tcfg, sched)
        self.step_fn = make_train_step(model, sched, dcfg, self.tcfg, cuda_graphs=cuda_graphs,
                                       mesh=mesh)
        self.draws = StepDraws(torch.Generator(device).manual_seed(args.seed),
                               torch.Generator().manual_seed(args.seed))
        # the data stream's position: the streamed loader's (epoch, next batch) and
        # the global numpy state after the last batch read; the cache's index
        # stream and the global numpy state of its last collation
        self.stream_pos = (0, 0)
        self.np_state = np.random.get_state()
        self.index_stream = None
        self.np_at_refresh = None
        self.served = 0

        self.resume_step = 0
        resume = args.resume_checkpoint or ckpt.latest_checkpoint(self.save_dir)
        restored = None
        if resume and Path(str(resume)).exists():
            restored = ckpt.load_checkpoint(resume)
            model.load_state_dict(restored["model"])
            self.state.load_state_dict(restored["train_state"])
            self.draws.load_state(restored["draws"])
            self.resume_step = self.state.step
            print(f"resumed from {resume} at step {self.resume_step}")
        self.device_data = self._maybe_cache_dataset_on_device(
            None if restored is None else restored["data"])
        if restored is not None and self.device_data is None:
            self.stream_pos = tuple(restored["data"]["stream_pos"])
            self.np_state = restored["data"]["np_state"]
            np.random.set_state(self.np_state)

    # ------------------------------------------------------------------ data
    def _maybe_cache_dataset_on_device(self, restored=None):
        """(the collated set on the card, its size), or None to stream.

        'auto' caches a set under 1 GiB whose items draw no randomness per
        access; 'true' caches any set and re-collates it every
        --device_cache_refresh steps so the per-item draws (crop, caption)
        go on re-sampling."""
        from condmdi_tpu_torch.data.dataset import collate

        mode = str(getattr(self.args, "device_data_cache", "false")).lower()
        if mode not in ("auto", "true"):
            return None
        loader = self.data_loader
        ds = loader.dataset
        random_items = bool(getattr(ds, "has_random_item_transforms", True))
        if mode == "auto" and random_items:
            print("device data cache skipped (the dataset re-samples crops/captions per "
                  "access; caching would freeze them: pass --device_data_cache true to force "
                  "with periodic re-collation)")
            return None
        my_idx = list(range(len(ds)))[loader.process_index:: loader.process_count]
        if not my_idx:
            return None
        if mode == "auto":
            one = collate([ds[my_idx[0]]], loader.max_motion_length, loader.text_encoder)
            est = len(my_idx) * sum(a.nbytes for k, a in one.items()
                                    if k not in ("text", "tokens"))
            if est > _CACHE_AUTO_CAP:
                print(f"device data cache skipped (dataset ~{est / 2**20:.0f} MiB > 1 GiB "
                      "auto cap; pass --device_data_cache true to force)")
                return None
        self._cache_idx = my_idx
        self.index_stream = _IndexStream(self.args.seed, loader.process_index)
        if restored is not None:
            self.index_stream.load_state(restored["index_stream"])
            self.served = restored["served"]
            np.random.set_state(restored["np_at_refresh"])
        full = self._collate_shard()
        if restored is not None:
            np.random.set_state(restored["np_state"])
        nbytes = sum(a.nbytes for a in full.values())
        print(f"device data cache: {len(my_idx)} clips, {nbytes / 2**20:.1f} MiB on "
              f"{self.device}; per-step transfer = index vector only")
        return [full, len(my_idx)]

    def _collate_shard(self) -> dict:
        """(Re-)collate this process's shard onto the card."""
        from condmdi_tpu_torch.data.dataset import collate

        self.np_at_refresh = np.random.get_state()
        loader = self.data_loader
        full = collate([loader.dataset[i] for i in self._cache_idx], loader.max_motion_length,
                       loader.text_encoder)
        self._host_lengths = torch.as_tensor(np.asarray(full["lengths"])).long()
        return batch_to_device(full, self.device)

    def _refresh_every(self) -> int:
        if not getattr(self.data_loader.dataset, "has_random_item_transforms", True):
            return 0
        return int(getattr(self.args, "device_cache_refresh", 1000) or 0)

    def _gather(self, data, idx) -> dict:
        """The batch at `idx` gathered on the card, with the lengths' host copy
        (`lengths_host`, which the keyframe masks are drawn from); the indices
        go up through pinned memory, so that the host does not wait for the card."""
        host = torch.as_tensor(np.asarray(idx)).long()
        on_card = host.pin_memory() if self.device.type == "cuda" else host
        idx = on_card.to(self.device, non_blocking=True)
        out = {k: v[idx] for k, v in data.items()}
        out["lengths_host"] = self._host_lengths[host]
        return out

    def _cached_batches(self, index_stream):
        """Endless batches gathered on the card from the cache."""
        data, n = self.device_data
        B = self.batch_size
        refresh = self._refresh_every()
        while True:
            if refresh and self.served and self.served % refresh == 0:
                data = self.device_data[0] = self._collate_shard()
            idx = index_stream.rng.choice(n, size=B, replace=n < B)
            self.served += 1
            yield self._gather(data, idx)

    def _streamed_batches(self):
        """Endless batches from the host loader through a prefetch thread, from
        the recorded position; the prefetcher is closed at every save."""
        from condmdi_tpu_torch.data.dataset import PrefetchIterator

        def produce():
            epoch, start = self.stream_pos
            for batch, pos in self.data_loader.batches(epoch, start):
                yield batch, pos, np.random.get_state()

        self._prefetch = PrefetchIterator(produce(), depth=2)
        for batch, pos, np_state in self._prefetch:
            self.stream_pos, self.np_state = pos, np_state
            out = batch_to_device(batch, self.device)
            out["lengths_host"] = torch.as_tensor(np.asarray(batch["lengths"])).long()
            yield out

    def _close_stream(self) -> None:
        """Stop the prefetch thread and put the global numpy stream back where the
        last batch read left it (the thread draws ahead)."""
        prefetch = getattr(self, "_prefetch", None)
        if prefetch is not None:
            prefetch.close()
            self._prefetch = None
            np.random.set_state(self.np_state)

    def _batches(self):
        if self.device_data is not None:
            if self.index_stream is None:
                self.index_stream = _IndexStream(self.args.seed, self.data_loader.process_index)
            return self._cached_batches(self.index_stream)
        return self._streamed_batches()

    # ------------------------------------------------------------------ loop
    def _log(self, metrics: dict, step: int, steps_per_sec: float) -> dict:
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = step
        m["steps_per_sec"] = steps_per_sec
        self.logger.logkvs(m)
        self.logger.dumpkvs()
        return m

    def run_loop(self):
        K = int(getattr(self.args, "steps_per_dispatch", 1) or 1)
        if K > 1 and self.device_data is not None:
            return self._run_loop_chained(K)

        step = self.resume_step
        t_last = time.time()
        batches = self._batches()
        while step < self.tcfg.num_steps:
            batch = next(batches)
            metrics = self.step_fn(self.state, batch, self.draws)
            if step % self.tcfg.log_interval == 0:
                rate = self.tcfg.log_interval / max(time.time() - t_last, 1e-9) if step else 0.0
                t_last = time.time()
                m = self._log(metrics, step, rate)
                print(f"step[{step}]: loss[{m['loss']:.5f}]")
            # checkpoint labels count the steps completed
            step += 1
            if step % self.tcfg.save_interval == 0:
                self._close_stream()
                self.save(step)
                self.evaluate(step)
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
                batches = self._batches()
        self._close_stream()
        if step % self.tcfg.save_interval != 0:  # the loop's last step, unless just saved
            self.save(step)

    def _run_loop_chained(self, K: int):
        """K steps per host iteration on batches gathered on the card; the tail
        (num_steps not divisible by K) single-step on a fresh index stream."""
        data, n = self.device_data
        B = self.batch_size
        refresh = self._refresh_every()
        step = self.resume_step
        t_last = time.time()
        last_logged = step
        print(f"chained training: {K} steps/dispatch")
        while step < self.tcfg.num_steps:
            if self.tcfg.num_steps - step < K:
                break
            if refresh and step and (step // refresh) != ((step - K) // refresh):
                data = self.device_data[0] = self._collate_shard()
            idx = self.index_stream.rng.choice(n, size=(K, B), replace=True)
            ms = [self.step_fn(self.state, self._gather(data, idx[i]), self.draws)
                  for i in range(K)]
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
            metrics["loss_last"] = ms[-1]["loss"]
            prev = step
            step += K
            if step - last_logged >= self.tcfg.log_interval or step >= self.tcfg.num_steps:
                rate = (step - last_logged) / max(time.time() - t_last, 1e-9)
                t_last = time.time()
                last_logged = step
                m = self._log(metrics, step, rate)
                print(f"step[{step}]: loss[{m['loss']:.5f}] ({rate:.1f} steps/s)")
            if (step // self.tcfg.save_interval) != (prev // self.tcfg.save_interval):
                self.save(step)
                self.evaluate(step)
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
        if step < self.tcfg.num_steps:
            tail = self._cached_batches(_IndexStream(self.args.seed,
                                                     self.data_loader.process_index))
            self.served = 0
            while step < self.tcfg.num_steps:
                self.step_fn(self.state, next(tail), self.draws)
                step += 1
        if step % self.tcfg.save_interval != 0:
            self.save(step)

    # ------------------------------------------------------------ save, eval
    def evaluate(self, step: int):
        """In-training evaluation: a debug-size pass of the port's evals.run on
        the EMA npz just saved. The evaluation reseeds the global RNGs, so they
        are kept and restored around it: the training stream goes on as if it
        had not run."""
        if not getattr(self.args, "eval_during_training", False):
            return
        import random

        py_state, np_state = random.getstate(), np.random.get_state()
        torch_state = torch.get_rng_state()
        try:
            from condmdi_tpu_torch.evals.run import main as eval_main

            summary = eval_main([
                "--eval_mode", "debug",
                "--model_path", str(self.save_dir / f"ema_{step:09d}.npz"),
                "--num_frames", str(self.args.num_frames),
                "--diffusion_steps", str(self.args.diffusion_steps),
                "--num_samples", str(self.args.eval_num_samples),
                "--guidance_param", "1.0",
                "--output_dir", str(self.save_dir / f"eval_{step:09d}"),
            ], device=self.device)
            # the metrics' means (the summary also names the weights' fingerprint)
            self.logger.logkvs({f"eval/{k}": float(np.ravel(v["mean"])[0])
                                for k, v in summary.items() if isinstance(v, dict)})
            self.logger.dumpkvs()
        except Exception as e:  # an evaluation never stops training
            print(f"in-training eval failed: {e}")
        finally:
            random.setstate(py_state)
            np.random.set_state(np_state)
            torch.set_rng_state(torch_state)

    def data_state(self) -> dict:
        if self.device_data is not None:
            return {"index_stream": self.index_stream.state(), "served": self.served,
                    "np_at_refresh": self.np_at_refresh, "np_state": np.random.get_state()}
        return {"stream_pos": self.stream_pos, "np_state": self.np_state}

    def save(self, step: int):
        from condmdi_tpu_torch.utils import checkpoint as ckpt
        from condmdi_tpu_torch.weights import to_flax_params

        state = {"step": step,
                 "model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                 "train_state": self.state.state_dict(), "draws": self.draws.state(),
                 "data": self.data_state()}
        path = ckpt.save_checkpoint(self.save_dir, step, state,
                                    ema_params=to_flax_params(self.state.ema))
        print(f"saved checkpoint {path}")


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    """Train from argv; returns the TrainLoop. On the card unless device="cpu"."""
    from condmdi_tpu_torch.data.dataset import DatasetConfig, get_dataset_loader
    from condmdi_tpu_torch.models.factory import create_gaussian_diffusion, create_model
    from condmdi_tpu_torch.models.flax_init import load_flax_init
    from condmdi_tpu_torch.models.text import make_text_encoder
    from condmdi_tpu_torch.utils.config import TrainArgs, parse_args, save_args_json

    from condmdi_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed()  # joins torchrun's group (and takes its card); one process: no-op
    dev = resolve_device(device)
    args = parse_args(TrainArgs, argv, base_card="motion_abs_unet_adagn_xl")
    seed_all(args.seed)

    save_dir = Path(args.save_dir or "save/condmdi_run")
    # an existing save_dir resumes from its newest checkpoint; --overwrite
    # removes its checkpoints first, so that the run starts afresh and no
    # sampler picks up a model trained under other options
    if args.overwrite and save_dir.exists():
        for stale in sorted(save_dir.glob("ckpt_*.pth")) + sorted(save_dir.glob("ema_*.npz")):
            stale.unlink()
    save_dir.mkdir(parents=True, exist_ok=True)
    save_args_json(args, save_dir / "args.json")

    data_cfg = DatasetConfig(
        name=args.dataset, data_dir=args.data_dir, max_motion_length=args.num_frames,
        abs_3d=args.abs_3d, traject_only=args.traj_only,
        use_random_projection=args.use_random_proj, augment_type=args.augment_type,
        std_scale_shift=tuple(args.std_scale_shift), drop_redundant=args.drop_redundant,
        synthetic_size=args.synthetic_size,
    )
    encoder = make_text_encoder(args, device=dev)
    # several processes (torchrun, one a card): data-parallel over them, each
    # loading its B/n rows from its shard of the data
    mesh, rank, world = None, 0, 1
    if initialize_distributed() and torch.distributed.get_world_size() > 1:
        from condmdi_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        rank, world = mesh.get_local_rank(), mesh.size()
        if args.batch_size % world:
            raise SystemExit(f"--batch_size {args.batch_size} is not divisible by the "
                             f"{world} processes")
    loader = get_dataset_loader(data_cfg, args.batch_size // world, text_encoder=encoder,
                                device=dev, process_index=rank, process_count=world)

    model = create_model(args, dev)
    load_flax_init(model, args.seed)
    model.train()
    sched, dcfg = create_gaussian_diffusion(args)
    loop = TrainLoop(args, model, sched.to(dev), dcfg, loader, dev, mesh=mesh)
    loop.run_loop()
    return loop


if __name__ == "__main__":
    main()
