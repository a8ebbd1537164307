"""The train step: keyframe injection, t sampling, loss, backward, clip, AdamW, EMA.

Counterpart of condmdi_tpu/training/loop.py (`TrainConfig`, the train state,
`make_optimizer`, `make_train_step`). One step, in the JAX step's order:

  1. keyframe-mask injection (CondMDI): a random observation mask
     (training/keyframes.py, the `keyframe_selection_scheme`), dropped for a
     whole sample with probability `keyframe_mask_prob`, and kept inside the
     sample's valid frames;
  2. t, uniform or from the loss-aware sampler;
  3. diffusion.gaussian.training_losses with the model in training mode
     (condition dropout, dropout), its per-sample loss times the sampler's
     importance weights, averaged;
  4. backward;
  5. optax's global-norm clip (g * max_norm / |g| once |g| >= max_norm), then
     AdamW (b1 0.9, eps 1e-8, weight decay on every parameter, GroupNorm and
     LayerNorm scales and biases included) at the learning rate of the update
     count before this one, linearly annealed to 0 over `lr_anneal_steps`
     when set;
  6. the EMA: ema * beta + params * (1 - beta);
  7. the loss-aware sampler's history;
  8. the metrics: loss, grad_norm (before the clip), param_norm (after the
     update), the terms' means and the loss by quartile of t.

The model's parameters are the master float32 copy and are updated in
place; with `use_bf16` the noisy input and the keyframes reach the model in
bfloat16 and the model promotes as the Flax modules do (models/unet.py).
Every random draw of a step comes from one `StepDraws`, which a test can
replace by one that replays another framework's draws. `remat` runs the
denoiser under torch.utils.checkpoint, with its dropout draws recorded on
the forward and replayed in the recompute.

Metrics stay on the device; reading them is the caller's sync. The host's
draw of the keyframe masks is recorded as the span `train.host_draw`
(utils/tracing.py) at every step (from the batch's `lengths_host`, it waits
for nothing on the card; without it, the lengths are read from the card
inside the span); a step that runs eagerly
(`make_train_step(..., cuda_graphs=False)`, the CPU) records its parts as the
spans `train.forward`, `train.backward` and `train.optimizer`, on the card
each timed by CUDA events as well. A replayed step records no part.

On the card the step is replayed from a CUDA graph, the counterpart of the
JAX package's jitted step (`BufferedTrainStep`): the host draws everything
the step draws, in the eager step's order, into static buffers (the
keyframe mask on the host, copied through pinned memory; the device generator's
draws, the model's condition-dropout and dropout masks included, into
device buffers), writes the learning rate into AdamW's device tensor
(AdamW is `capturable=True` on CUDA, with the learning rate a device
tensor, in both modes) and replays one graph of forward, backward, clip,
AdamW and the EMA. The first step runs eagerly and names the model's
draws; the second captures the graph under
`weight_cache.repack_on_every_call()`, so that the graph re-packs the
weights its own AdamW step updates. A data-parallel step is replayed as two
graphs, with the gradients' all-reduce between them on the host. The eager
step stays for the loss-aware sampler (its draw reads t and the losses on
the host), for a tensor-parallel step and on the CPU, by rule.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch import nn

from condmdi_tpu_torch.diffusion.gaussian import DiffusionConfig, training_losses
from condmdi_tpu_torch.diffusion.resample import LossAwareState, uniform_sample_t
from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule
from condmdi_tpu_torch.models.layers import TrainDraws
from condmdi_tpu_torch.training.keyframes import get_keyframes_mask
from condmdi_tpu_torch.utils import tracing


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    adam_beta2: float = 0.999
    grad_clip: float = 1.0
    avg_model_beta: float = 0.9999
    lr_anneal_steps: int = 0
    num_steps: int = 1_200_000
    batch_size: int = 64
    log_interval: int = 1_000
    save_interval: int = 100_000
    schedule_sampler: str = "uniform"
    # keyframe conditioning (CondMDI)
    keyframe_conditioned: bool = False
    keyframe_selection_scheme: str = "random_frames"
    keyframe_mask_prob: float = 0.1
    zero_keyframe_loss: bool = False
    use_bf16: bool = False
    # recompute the denoiser's forward in the backward instead of keeping its activations
    remat: bool = False


@dataclass
class TrainState:
    """What a step changes besides the model's parameters."""

    step: int
    ema: dict[str, torch.Tensor]  # parameter name -> EMA (float32)
    optimizer: torch.optim.Optimizer
    loss_aware: Optional[LossAwareState] = None
    params: dict[str, nn.Parameter] = field(default_factory=dict)

    def state_dict(self) -> dict:
        return {"step": self.step, "ema": {k: v.detach().cpu() for k, v in self.ema.items()},
                "optimizer": self.optimizer.state_dict(),
                "loss_aware": None if self.loss_aware is None else self.loss_aware.state_dict()}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        for k, v in d["ema"].items():
            self.ema[k].copy_(v)
        # a tensor learning rate stays the tensor the step (and its graph) writes
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(d["optimizer"])
        for group, lr in zip(self.optimizer.param_groups, lrs):
            if isinstance(lr, torch.Tensor):
                lr.fill_(float(group["lr"]))
                group["lr"] = lr
        if self.loss_aware is not None:
            self.loss_aware.load_state_dict(d["loss_aware"])


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.linear_schedule(lr, 0, lr_anneal_steps) at the update count before
    this update (the first update uses lr), or the constant lr."""
    if not cfg.lr_anneal_steps:
        return cfg.lr
    frac = 1.0 - min(max(count, 0), cfg.lr_anneal_steps) / cfg.lr_anneal_steps
    return cfg.lr * frac


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW as optax.adamw configures it: b1 0.9, b2 adam_beta2, eps 1e-8, the
    decay on every parameter. On CUDA it is capturable (its step count on the
    card) and its learning rate a float32 tensor on the card, which
    `set_learning_rate` writes, so that one CUDA graph holds the whole step;
    on the CPU the learning rate is a Python float, as before."""
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    if device.type == "cuda":
        return torch.optim.AdamW(params, lr=torch.tensor(cfg.lr, device=device),
                                 betas=(0.9, cfg.adam_beta2), eps=1e-8,
                                 weight_decay=cfg.weight_decay, capturable=True)
    return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, cfg.adam_beta2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's learning rate: written into its tensor where it has one
    (a launch, no sync), else set as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float, g_norm: torch.Tensor):
    """optax.clip_by_global_norm in place: g / |g| * max_norm once |g| >= max_norm,
    g untouched below; no host sync."""
    trigger = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
    torch._foreach_mul_(grads, torch.where(trigger, one, one * max_norm))


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       sched: DiffusionSchedule) -> TrainState:
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return TrainState(
        step=0,
        ema={n: p.detach().clone() for n, p in params.items()},
        optimizer=make_optimizer(params.values(), cfg),
        loss_aware=(LossAwareState.create(sched.num_timesteps)
                    if cfg.schedule_sampler == "loss-second-moment" else None),
        params=params,
    )


class StepDraws:
    """Every random draw of a train step. `generator` lives on the model's
    device (t, the keyframe drop, the noise, the model's dropout draws);
    `keyframe_generator` is a CPU generator for the host's draws: the keyframe
    masks (training/keyframes.py) and the loss-aware sampler's t."""

    def __init__(self, generator: torch.Generator, keyframe_generator: torch.Generator):
        self.generator = generator
        self.keyframe_generator = keyframe_generator

    def keyframe_mask(self, lengths, T: int, scheme: str) -> torch.Tensor:
        return get_keyframes_mask(lengths, T, edit_mode=scheme,
                                  generator=self.keyframe_generator)

    def keyframe_drop(self, B: int, prob: float, device) -> torch.Tensor:
        """[B, 1, 1] bool: True drops a sample's keyframes."""
        return torch.rand((B, 1, 1), generator=self.generator, device=device) < prob

    def timesteps(self, loss_aware: Optional[LossAwareState], B: int, num_timesteps: int,
                  device):
        if loss_aware is not None:
            # the sampler's state lives on the host, and so its draw
            t, w = loss_aware.sample(B, self.keyframe_generator)
            return t.to(device), w.to(device)
        return uniform_sample_t(B, num_timesteps, self.generator, device)

    def noise(self, shape, dtype, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def model(self) -> TrainDraws:
        return TrainDraws(self.generator)

    def state(self) -> dict:
        return {"generator": self.generator.get_state(),
                "keyframe_generator": self.keyframe_generator.get_state()}

    def load_state(self, d: dict) -> None:
        self.generator.set_state(d["generator"])
        self.keyframe_generator.set_state(d["keyframe_generator"])


class _RecordedDraws:
    """A model's draws recorded on the first forward and replayed, in order, by
    the recompute torch.utils.checkpoint makes in the backward."""

    def __init__(self, draws):
        self.draws, self.saved, self.i = draws, [], 0

    def keep(self, shape, keep_prob, device):
        if self.i < len(self.saved):
            out = self.saved[self.i]
        else:
            out = self.draws.keep(shape, keep_prob, device)
            self.saved.append(out)
        self.i += 1
        return out


@dataclass
class StepInputs:
    """Everything one step reads besides the model and its state: the batch and
    the step's draws (the keyframe mask as drawn, before the drop and the
    valid-frame mask; None without keyframes)."""

    motion: torch.Tensor
    time_mask: torch.Tensor
    y: dict
    t: torch.Tensor
    weights: torch.Tensor
    noise: torch.Tensor
    obs_mask: Optional[torch.Tensor] = None
    drop: Optional[torch.Tensor] = None


class _RowDraws:
    """A model's draws on a data-parallel rank: each drawn at the global batch's
    shape (the local rows times the mesh size) and cut to this rank's rows, so
    that a row gets the mask it gets on one process."""

    def __init__(self, draws, mesh):
        from condmdi_tpu_torch.parallel.mesh import dp_part

        mesh = dp_part(mesh)
        self.draws, self.mesh, self.n = draws, mesh, mesh.size()

    def keep(self, shape, keep_prob, device):
        from condmdi_tpu_torch.parallel.mesh import rows_of

        full = (shape[0] * self.n,) + tuple(shape[1:])
        return self.draws.keep(full, keep_prob, device)[rows_of(self.mesh, full[0])]


def _model_draws(draws: StepDraws, mesh):
    """The model's draws of a step: on a data-parallel rank, the rank's rows of them."""
    return draws.model() if mesh is None else _RowDraws(draws.model(), mesh)


def draw_step_inputs(state: TrainState, batch: dict, draws: StepDraws, tcfg: TrainConfig,
                     num_timesteps: int, mesh=None) -> StepInputs:
    """The step's draws in the JAX step's order (the keyframe mask, its drop, t,
    the noise; the model's own draws come during the forward). The mask is
    drawn from the batch's host copy of the lengths where it has one.

    With a data-parallel `mesh` the batch holds this rank's rows: every draw is
    made at the global batch's shape (the keyframe mask from the lengths
    gathered from every rank) and cut to the rank's rows, so that each row gets
    the draw it gets in a single-process step on the global batch."""
    motion = batch["motion"]
    B, T = motion.shape[:2]
    device = motion.device
    rows = None
    if mesh is not None:
        from condmdi_tpu_torch.parallel.mesh import dp_part, rows_of

        mesh = dp_part(mesh)
        B = B * mesh.size()
        rows = rows_of(mesh, B)

    def mine(x):
        return x if rows is None or x is None else x[rows]

    obs_mask = drop = None
    if tcfg.keyframe_conditioned:
        lengths = batch.get("lengths_host", batch["lengths"])
        if mesh is not None:
            from condmdi_tpu_torch.parallel.mesh import all_gather_rows

            lengths = all_gather_rows(mesh, torch.as_tensor(lengths))
        with tracing.span("train.host_draw", rows=B):
            mask = draws.keyframe_mask(lengths, T, tcfg.keyframe_selection_scheme)
        obs_mask = mine(mask)
        if tcfg.keyframe_mask_prob > 0.0:
            drop = mine(draws.keyframe_drop(B, tcfg.keyframe_mask_prob, device))
    t, weights = draws.timesteps(state.loss_aware, B, num_timesteps, device)
    noise = draws.noise((B,) + tuple(motion.shape[1:]), motion.dtype, device)
    y = {k: batch[k] for k in ("text_embed", "action") if k in batch}
    return StepInputs(motion, batch["time_mask"], y, mine(t), mine(weights), mine(noise),
                      obs_mask, drop)


class _StepBody:
    """`body(state, inputs, model_draws) -> (metrics, per-sample loss)`: the step
    from the drawn inputs on; the learning rate is set beforehand
    (`set_learning_rate`). Its parts, which `BufferedTrainStep` replays apart
    under a mesh: `forward_backward` (the loss and every parameter's gradient),
    `update` (the clip, AdamW, the EMA and the rank's metrics) and `finish`
    (the metrics over the global batch, the loss by quartile of t).

    With a data-parallel `mesh` the gradients are all-reduced to their mean
    over the ranks between `forward_backward` and `update`, and `finish`
    averages the metrics and gathers the per-sample losses and t from every
    rank. With a ('dp', 'tp') mesh the model is a tensor-parallel copy
    (parallel/tp.py): the gradients are averaged over 'dp' and the norms taken
    over the slices of every tp rank.

    `timed` (set by `make_train_step` where the step runs eagerly) records the
    step's parts as the spans train.forward, train.backward and
    train.optimizer, device-timed on the card; a captured body records none."""

    def __init__(self, model: nn.Module, sched: DiffusionSchedule, dcfg: DiffusionConfig,
                 tcfg: TrainConfig, mesh=None):
        self.model, self.sched, self.dcfg, self.tcfg = model, sched, dcfg, tcfg
        self.timed = False
        self.mesh = self.dp = mesh
        self.norm = global_norm
        self.sharded: list[bool] = []  # which parameters are tensor-parallel slices
        if mesh is not None:
            from condmdi_tpu_torch.parallel.mesh import dp_part
            from condmdi_tpu_torch.parallel.tp import tp_global_norm, tp_group_of

            tp_group, self.dp = tp_group_of(mesh), dp_part(mesh)
            if tp_group is not None:
                self.norm = lambda tensors: tp_global_norm(tensors, self.sharded, tp_group)

    def _part(self, name: str):
        if not self.timed:
            return contextlib.nullcontext()
        return tracing.span(name, device=next(self.model.parameters()).is_cuda)

    def forward_backward(self, state: TrainState, inp: StepInputs, model_draws):
        """The weighted loss and the loss terms; every parameter holds its gradient
        (zero where the loss does not reach it)."""
        with self._part("train.forward"):
            loss, terms = self._forward(inp, model_draws)
        with self._part("train.backward"):
            state.optimizer.zero_grad()
            loss.backward()
            params = list(state.params.values())
            self.sharded[:] = [getattr(p, "tp_sharded", False) for p in params]
            for p in params:  # optax updates every leaf: an unreached one has a zero gradient
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    def _forward(self, inp: StepInputs, model_draws):
        tcfg, model = self.tcfg, self.model
        motion = inp.motion
        obs_mask = None
        if tcfg.keyframe_conditioned:
            obs_mask = inp.obs_mask.to(motion.device)
            if inp.drop is not None:
                obs_mask = obs_mask & ~inp.drop
            obs_mask = obs_mask & inp.time_mask[..., None]  # a subset of the valid frames
        y = inp.y

        def denoise_with(md, x_t, t_model):
            if tcfg.use_bf16:
                x_t = x_t.to(torch.bfloat16)
            kw = {}
            if tcfg.keyframe_conditioned:
                kw = dict(obs_x0=motion.to(x_t.dtype), obs_mask=obs_mask)
            return model(x_t, t_model, y, draws=md, **kw).float()

        if tcfg.remat:
            recorded = _RecordedDraws(model_draws)

            def run(x_t, t_model):
                recorded.i = 0
                return denoise_with(recorded, x_t, t_model)

            def denoise(x_t, t_model):
                return torch.utils.checkpoint.checkpoint(run, x_t, t_model, use_reentrant=False)
        else:
            def denoise(x_t, t_model):
                return denoise_with(model_draws, x_t, t_model)

        terms = training_losses(denoise, self.sched, self.dcfg, motion, inp.t, inp.noise,
                                inp.time_mask, obs_mask=obs_mask,
                                zero_keyframe_loss=tcfg.zero_keyframe_loss,
                                keyframe_conditioned=tcfg.keyframe_conditioned)
        return torch.mean(terms["loss"] * inp.weights), terms

    @staticmethod
    def grads(state: TrainState) -> list[torch.Tensor]:
        return [p.grad for p in state.params.values()]

    def average_grads(self, flat: torch.Tensor) -> None:
        """The mean of the ranks' gradients (the global batch's), in place, over the
        gradients laid end to end in `flat`."""
        from condmdi_tpu_torch.parallel.mesh import all_reduce_mean_

        all_reduce_mean_(self.dp, flat)

    @staticmethod
    def unflatten_(grads: list[torch.Tensor], flat: torch.Tensor) -> None:
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    @torch.no_grad()
    def update(self, state: TrainState, loss: torch.Tensor, terms: dict):
        """The clip, AdamW and the EMA from the gradients the parameters hold; the
        rank's metrics and per-sample loss."""
        tcfg = self.tcfg
        params = list(state.params.values())
        grads = self.grads(state)
        grad_norm = self.norm(grads)
        if tcfg.grad_clip > 0:
            clip_by_global_norm_(grads, tcfg.grad_clip, grad_norm)
        state.optimizer.step()

        beta = tcfg.avg_model_beta
        ema = list(state.ema.values())
        if beta > 0:
            torch._foreach_mul_(ema, beta)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - beta)
        else:
            torch._foreach_copy_(ema, [p.detach() for p in params])

        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "param_norm": self.norm([p.detach() for p in params])}
        for k in ("rot_mse", "keyframes_mse", "vel_mse", "vb"):
            if k in terms:
                metrics[k] = terms[k].mean()
        return metrics, terms["loss"]

    @torch.no_grad()
    def finish(self, metrics: dict, per_sample: torch.Tensor, t: torch.Tensor):
        """The metrics over the global batch (under a mesh: the ranks' means
        averaged, the per-sample losses and t gathered) and the loss by quartile of
        t; returns (metrics, per-sample loss)."""
        metrics = dict(metrics)
        if self.mesh is not None:
            from condmdi_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_mean_

            for k in [k for k in metrics if k not in ("grad_norm", "param_norm")]:
                metrics[k] = all_reduce_mean_(self.dp, metrics[k].clone())
            per_sample, t = all_gather_rows(self.dp, per_sample), all_gather_rows(self.dp, t)
        quartile = (4 * t / self.sched.num_timesteps).to(torch.int32)
        for q in range(4):
            sel = quartile == q
            metrics[f"loss_q{q}"] = (torch.where(sel, per_sample, 0.0).sum()
                                     / sel.sum().clamp(min=1))
        return metrics, per_sample

    def __call__(self, state: TrainState, inp: StepInputs, model_draws):
        loss, terms = self.forward_backward(state, inp, model_draws)
        with self._part("train.optimizer"):
            if self.mesh is not None:
                with torch.no_grad():
                    grads = self.grads(state)
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    self.average_grads(flat)
                    self.unflatten_(grads, flat)
            metrics, per_sample = self.update(state, loss, terms)
            return self.finish(metrics, per_sample, inp.t)


def _step_body(model: nn.Module, sched: DiffusionSchedule, dcfg: DiffusionConfig,
               tcfg: TrainConfig, mesh=None) -> _StepBody:
    return _StepBody(model, sched, dcfg, tcfg, mesh)


def make_train_step(model: nn.Module, sched: DiffusionSchedule, dcfg: DiffusionConfig,
                    tcfg: TrainConfig, cuda_graphs: bool = True, mesh=None,
                    ) -> Callable[[TrainState, dict, StepDraws], dict]:
    """`train_step(state, batch, draws) -> metrics`, updating the model and state.

    batch: motion [B, T, F], time_mask [B, T], lengths [B], and text_embed
    [B, 512] / action [B] where the model takes them, on the model's device
    (and optionally `lengths_host`, the lengths on the host, which the
    keyframe mask is drawn from). On CUDA, unless `cuda_graphs` is False, the
    loss-aware sampler is in use or a 2-D ('dp', 'tp') mesh is given, the step
    is a `BufferedTrainStep` replayed from CUDA graphs; otherwise it runs
    eagerly and records its parts as spans (`_StepBody.timed`).

    `mesh`: a data-parallel DeviceMesh (parallel/mesh.py make_mesh). The batch
    then holds this rank's B/n rows of a global batch of B (the ranks' batches
    in rank order), every rank holds the same model and state and draws from
    generators seeded alike, and the step equals a single-process step on the
    global batch (training/loop.py `draw_step_inputs`, `_StepBody`): the
    counterpart of the JAX package's train step on a 'dp' mesh.
    """
    body = _step_body(model, sched, dcfg, tcfg, mesh)
    device = next(model.parameters()).device
    # a tensor-parallel step stays eager: its forward's collectives would sit inside a graph
    if (cuda_graphs and device.type == "cuda"
            and (mesh is None or mesh.ndim == 1) and tcfg.schedule_sampler == "uniform"):
        return BufferedTrainStep(model, sched, tcfg, body)
    body.timed = True

    def train_step(state: TrainState, batch: dict, draws: StepDraws) -> dict:
        inputs = draw_step_inputs(state, batch, draws, tcfg, sched.num_timesteps, mesh)
        set_learning_rate(state.optimizer, learning_rate(tcfg, state.step))
        metrics, per_sample = body(state, inputs, _model_draws(draws, mesh))
        if state.loss_aware is not None:
            t = inputs.t
            if mesh is not None:  # body gathered the losses; the sampler sees the global t
                from condmdi_tpu_torch.parallel.mesh import all_gather_rows, dp_part

                t = all_gather_rows(dp_part(mesh), t)
            state.loss_aware = state.loss_aware.update(t.cpu(), per_sample.cpu())
        state.step += 1
        return metrics

    return train_step


class _RecordingDraws:
    """A model's draws passed through, their shapes and keep probabilities noted."""

    def __init__(self, draws):
        self.draws, self.calls = draws, []

    def keep(self, shape, keep_prob, device):
        self.calls.append((tuple(shape), keep_prob))
        return self.draws.keep(shape, keep_prob, device)


class _BufferedDraws:
    """The model's draws of one step, drawn before it into static buffers and
    handed out in the order the forward asks for them."""

    def __init__(self, calls, device):
        self.calls = calls
        self.masks = [torch.zeros(shape, dtype=torch.bool, device=device) for shape, _ in calls]
        self.i = 0

    def fill(self, draws) -> None:
        """Draw this step's masks, in the forward's order, into the buffers."""
        for (shape, keep_prob), mask in zip(self.calls, self.masks):
            mask.copy_(draws.keep(shape, keep_prob, mask.device))
        self.i = 0

    def keep(self, shape, keep_prob, device):
        expected = self.calls[self.i]
        if expected != (tuple(shape), keep_prob):
            raise RuntimeError(f"the forward drew {(tuple(shape), keep_prob)} where its first "
                               f"step drew {expected}")
        self.i += 1
        return self.masks[self.i - 1]


class BufferedTrainStep:
    """The train step over static buffers, replayed from CUDA graphs on the card.

    Called as the eager step is, `step(state, batch, draws) -> metrics`. The
    first call runs the eager step and notes the model's draws; from the
    second on, the host copies the batch and the step's draws (drawn as the
    eager step draws them, in its order) into static buffers, writes the
    learning rate into AdamW's tensor and runs the body over the buffers: on
    the card a `CudaGraph` of it (captured at the second call under
    `weight_cache.repack_on_every_call()`, again where the model's weights or
    the kernels' implementation changed), on the CPU the body itself. The
    metrics come back as a copy, so that K steps can be kept before they are
    read. The state passed must stay the same object across calls.

    Under a data-parallel mesh (the body's) no collective is captured: one
    graph runs the forward and backward and lays the gradients end to end in a
    static buffer, the host all-reduces that buffer across the ranks, a second
    graph runs the clip, AdamW and the EMA from it, and the host then averages
    the metrics and gathers the per-sample losses (`_StepBody.finish`).
    """

    def __init__(self, model: nn.Module, sched: DiffusionSchedule, tcfg: TrainConfig, body):
        self.model, self.sched, self.tcfg, self.body = model, sched, tcfg, body
        self.mesh = body.mesh
        self.inputs: Optional[StepInputs] = None
        self.model_draws: Optional[_BufferedDraws] = None
        self.graph = None  # the step's graph; under a mesh, its forward and backward's
        self.update_graph = None  # under a mesh: the clip, AdamW and the EMA
        self.state = None
        self.flat = self.loss = self.terms = None  # under a mesh: what the two graphs share

    def _eager(self, state, batch, draws):
        inputs = draw_step_inputs(state, batch, draws, self.tcfg, self.sched.num_timesteps,
                                  self.mesh)
        set_learning_rate(state.optimizer, learning_rate(self.tcfg, state.step))
        recording = _RecordingDraws(_model_draws(draws, self.mesh))
        metrics, _ = self.body(state, inputs, recording)
        device = inputs.motion.device
        # the static buffers, shaped as this step's inputs
        self.inputs = StepInputs(**{
            k: (None if v is None else {n: torch.zeros_like(u) for n, u in v.items()}
                if isinstance(v, dict) else torch.zeros_like(v, device=device))
            for k, v in vars(inputs).items()})
        self.model_draws = _BufferedDraws(recording.calls, device)
        self.state = state
        return metrics

    def _load(self, state, batch, draws) -> None:
        drawn = draw_step_inputs(state, batch, draws, self.tcfg, self.sched.num_timesteps,
                                 self.mesh)
        buf = self.inputs
        for name in ("motion", "time_mask", "t", "weights", "noise", "drop"):
            src = getattr(drawn, name)
            if src is not None:
                getattr(buf, name).copy_(src)
        for k, v in drawn.y.items():
            buf.y[k].copy_(v)
        if drawn.obs_mask is not None:
            mask = drawn.obs_mask
            if mask.device.type == "cpu" and buf.obs_mask.device.type == "cuda":
                mask = mask.pin_memory()  # host → pinned → card, without a sync
            buf.obs_mask.copy_(mask, non_blocking=True)
        self.model_draws.fill(_model_draws(draws, self.mesh))
        set_learning_rate(state.optimizer, learning_rate(self.tcfg, state.step))

    def _run_body(self):
        from condmdi_tpu_torch.ops.weight_cache import repack_on_every_call

        self.model_draws.i = 0
        with repack_on_every_call():
            metrics, _ = self.body(self.state, self.inputs, self.model_draws)
        return metrics

    def _run_forward_backward(self) -> None:
        """The mesh's first graph: the loss terms and the gradients, laid end to
        end, into the buffers the second graph reads."""
        from condmdi_tpu_torch.ops.weight_cache import repack_on_every_call

        self.model_draws.i = 0
        with repack_on_every_call():
            loss, terms = self.body.forward_backward(self.state, self.inputs, self.model_draws)
        grads = self.body.grads(self.state)
        if self.flat is None:  # made in the first call, which runs eagerly
            self.flat = torch.empty(sum(g.numel() for g in grads), dtype=grads[0].dtype,
                                    device=grads[0].device)
            self.loss = torch.empty_like(loss)
            self.terms = {k: torch.empty_like(v) for k, v in terms.items()}
        torch.cat([g.reshape(-1) for g in grads], out=self.flat)
        self.loss.copy_(loss)
        for k, v in terms.items():
            self.terms[k].copy_(v)

    def _run_update(self):
        self.body.unflatten_(self.body.grads(self.state), self.flat)
        return self.body.update(self.state, self.loss, self.terms)

    def _replay_update(self):
        captures = self.update_graph.captures
        out = self.update_graph()
        if self.update_graph.captures != captures:
            # the capture's warm-up stepped AdamW eagerly, which moved the parameters'
            # version counters that the first graph's key holds
            self.graph.key = self.graph.validity_key()
        return out

    def _run_mesh(self, cuda: bool) -> dict:
        forward_backward, update = self._run_forward_backward, self._run_update
        if cuda:
            if self.graph is None:
                from condmdi_tpu_torch.utils.cuda_graph import CudaGraph

                self.graph = CudaGraph(self._run_forward_backward, [self.model],
                                       watch_generation=False)
                self.update_graph = CudaGraph(self._run_update, [self.model],
                                              advances_generation=True)
            forward_backward, update = self.graph, self._replay_update
        forward_backward()
        with torch.no_grad():
            self.body.average_grads(self.flat)
        metrics, per_sample = update()
        return self.body.finish(metrics, per_sample, self.inputs.t)[0]

    def __call__(self, state: TrainState, batch: dict, draws: StepDraws) -> dict:
        if self.inputs is None:
            metrics = self._eager(state, batch, draws)
        else:
            if state is not self.state:
                raise ValueError("BufferedTrainStep: one TrainState object across its steps")
            self._load(state, batch, draws)
            cuda = self.inputs.motion.device.type == "cuda"
            if self.mesh is not None:
                metrics = self._run_mesh(cuda)
            elif cuda:
                if self.graph is None:
                    from condmdi_tpu_torch.utils.cuda_graph import CudaGraph

                    self.graph = CudaGraph(self._run_body, [self.model],
                                           advances_generation=True)
                metrics = self.graph()
            else:
                metrics = self._run_body()
            names = list(metrics)
            values = torch.stack([metrics[k] for k in names])  # a copy the next step keeps
            metrics = dict(zip(names, values.unbind()))
        state.step += 1
        return metrics
