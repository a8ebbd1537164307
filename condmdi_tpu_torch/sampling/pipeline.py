"""End-to-end sampling pipeline: model + schedule + guidance → motions.

Counterpart of condmdi_tpu/sampling/pipeline.py for the DDPM, DDIM and PLMS
samplers. Where the JAX pipeline jits one program per sampling configuration,
this one keeps a `SamplingProgram` per configuration and replays its sampler
step from CUDA graphs (utils/cuda_graph.py); the CLIs, evals.run and
MotionServer reach the graphs through `SamplePipeline.sample`. PLMS replays
its multistep body, its first (Heun) step runs eagerly. A run guided by a
`cond_loss_fn` (GMD, sampling/gmd.py) takes a gradient through the denoiser
every step and runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from condmdi_tpu_torch.data.humanml_repr import recover_from_ric
from condmdi_tpu_torch.device import resolve_device
from condmdi_tpu_torch.diffusion.gaussian import (
    DiffusionConfig,
    InpaintingState,
    get_gradient_schedule,
)
from condmdi_tpu_torch.diffusion.sampling import (
    PLMSBuffers,
    PLMSStep,
    SamplerConfig,
    SamplerStep,
    StepBuffers,
    at_model_step,
    eager_loop,
    initial_x,
    plms_body_steps,
    plms_eager_loop,
    plms_run_on_buffers,
    plms_step_body,
    run_on_buffers,
    sampler_steps,
    step_body,
)
from condmdi_tpu_torch.diffusion.schedule import DiffusionSchedule
from condmdi_tpu_torch.models.cfg import (
    conditioning_signature,
    make_cfg_denoiser,
    make_plain_denoiser,
)
from condmdi_tpu_torch.utils import tracing
from condmdi_tpu_torch.utils.cuda_graph import CudaGraph


def build_inpainting_state(
    inpainted_motion: torch.Tensor,
    inpainting_mask: torch.Tensor,
    time_mask: Optional[torch.Tensor] = None,
    imputate: bool = False,
    reconstruction_guidance: bool = False,
    reconstruction_weight: float = 5.0,
    gradient_schedule: Optional[str] = None,
    stop_imputation_at: int = 0,
    stop_recguidance_at: int = 0,
    replacement_distribution: str = "conditional",
    diffusion_steps: int = 1000,
) -> InpaintingState:
    """Assemble the inpainting state from CondSynt-style options.

    The gradient schedule is indexed by the RESPACED step, with length
    diffusion_steps, as in the reference.
    """
    if time_mask is not None:
        inpainting_mask = inpainting_mask & time_mask[..., None].bool()
    grad_ws = get_gradient_schedule(gradient_schedule, diffusion_steps)
    return InpaintingState(
        inpainted_motion=inpainted_motion,
        inpainting_mask=inpainting_mask,
        grad_weights=torch.as_tensor(
            np.asarray(grad_ws * reconstruction_weight, np.float32),
            device=inpainted_motion.device,
        ),
        stop_imputation_at=int(stop_imputation_at),
        stop_recguidance_at=int(stop_recguidance_at),
        imputate=imputate,
        reconstruction_guidance=reconstruction_guidance,
        replacement_distribution=replacement_distribution,
    )


def _behind(fn, depth: int = 3):
    """`fn` and what it closes over, depth first: the objects behind an apply_fn."""
    yield fn
    for cell in (getattr(fn, "__closure__", None) or ()) if depth else ():
        try:
            value = cell.cell_contents
        except ValueError:  # an empty cell
            continue
        if value is not fn and callable(value):
            yield from _behind(value, depth - 1)


def networks_of(fn) -> list[nn.Module]:
    """The modules whose weights an apply_fn reads: the first module, or the first
    `networks()` (MixedStepDenoiser's), found in it or behind it."""
    for obj in _behind(fn):
        if isinstance(obj, nn.Module):
            return [obj]
        own = getattr(obj, "networks", None)
        if callable(own):
            return list(own())
    return []


def branch_of(fn):
    """The `branch(t_model)` of a denoiser that switches networks by timestep
    (MixedStepDenoiser), found in an apply_fn or behind it; None for one network."""
    for obj in _behind(fn):
        if isinstance(obj, nn.Module):
            return None
        branch = getattr(obj, "branch", None)
        if callable(branch):
            return branch
    return None


def _inpaint_form(inpaint: Optional[InpaintingState]):
    if inpaint is None:
        return None
    return (inpaint.imputate, inpaint.reconstruction_guidance,
            inpaint.replacement_distribution, inpaint.stop_imputation_at,
            inpaint.stop_recguidance_at,
            *((tuple(t.shape), t.dtype) for t in (inpaint.inpainted_motion,
                                                  inpaint.inpainting_mask,
                                                  inpaint.grad_weights)))


class SamplingProgram:
    """One (shape, guidance, conditioning, inpainting form) of a pipeline: the
    counterpart of one jitted JAX sampling program.

    It holds the denoiser with its conditioning buffers (models/cfg.py), its own
    copy of the inpainting tensors, the step's static buffers and, on the card,
    one CUDA graph per branch of the apply_fn (one, or the mixed step's two).
    `load` copies a request's values into the buffers; `run` samples. With
    `buffered`, each step writes t and the noise into the buffers and, on the
    card, replays the branch's graph (captured at its first step, and again
    where its weights or the kernels' implementation changed), or, on the CPU,
    runs the same body on the buffers (for tests); without, the same step runs
    eagerly (`diffusion.sampling.eager_loop`). A step that runs autograd
    (reconstruction guidance, a `cond_loss_fn`) is never buffered. PLMS keeps
    its eps history in its buffers (`PLMSBuffers`) and runs its first step
    eagerly before the body's replays.
    """

    def __init__(self, pipe: "SamplePipeline", shape, y, guidance_param, obs_x0, obs_mask,
                 inpaint, buffered: bool, cond_loss_fn=None, cond_scale: float = 1.0):
        self.pipe, self.shape = pipe, tuple(shape)
        self.denoise = pipe.denoiser(y, guidance_param, obs_x0, obs_mask)
        self.inpaint = None if inpaint is None else replace(
            inpaint, inpainted_motion=inpaint.inpainted_motion.clone(),
            inpainting_mask=inpaint.inpainting_mask.clone(),
            grad_weights=inpaint.grad_weights.clone())
        sampler = pipe.sampler
        self.plms = sampler.method == "plms"
        if self.plms:
            self.step = PLMSStep(self.denoise, pipe.sched, pipe.dcfg, sampler, self.inpaint)
        else:
            self.step = SamplerStep(sampler.method, self.denoise, pipe.sched, pipe.dcfg, sampler,
                                    self.inpaint, cond_loss_fn=cond_loss_fn,
                                    cond_scale=cond_scale)
        self.buffered = buffered and self.step.capturable
        self.buffers: Optional[StepBuffers | PLMSBuffers] = None
        self.graphs: dict[Any, Callable] = {}

    def load(self, y, obs_x0=None, obs_mask=None, inpaint=None) -> None:
        self.denoise.load(y, obs_x0, obs_mask)
        if inpaint is not None:
            self.inpaint.inpainted_motion.copy_(inpaint.inpainted_motion)
            self.inpaint.inpainting_mask.copy_(inpaint.inpainting_mask)
            self.inpaint.grad_weights.copy_(inpaint.grad_weights)

    def _branch(self, ti: int):
        branch = branch_of(self.pipe.apply_fn)
        return None if branch is None else branch(self.pipe.sched.model_t_host(ti))

    def _graph(self, branch) -> Callable:
        """The branch's graph (`graph(check)` replays it); on the CPU its body."""
        graph = self.graphs.get(branch)
        make_body = plms_step_body if self.plms else step_body
        if graph is None and self.pipe.device.type != "cuda":
            body = make_body(self.step, self.buffers)
            graph = self.graphs[branch] = lambda check=True: body()
        if graph is None:
            networks = networks_of(self.pipe.apply_fn)
            if not networks:
                raise ValueError("SamplePipeline: no module found behind apply_fn to key its "
                                 "CUDA graphs on; give apply_fn a networks() method")
            graph = self.graphs[branch] = CudaGraph(make_body(self.step, self.buffers), networks,
                                                    pool=self.pipe.graph_pool())
        return graph

    def _ensure_buffers(self, x) -> None:
        if self.buffers is not None and self.buffers.x.dtype != x.dtype:
            self.buffers, self.graphs = None, {}  # graphs read the buffers they were given
        if self.buffers is None and self.plms:
            self.buffers = PLMSBuffers.create(x.shape, x.dtype, x.device, self.step.order)
        elif self.buffers is None:
            self.buffers = StepBuffers.create(x.shape, x.dtype, x.device, self.step.marginal)

    def warm(self) -> None:
        """Make every branch ready now, each at its first step on the buffers as
        they are: with graphs, its graph captured (or its key checked), as the JAX
        server compiles a bucket; without, one denoiser forward, which builds the
        kernels."""
        self._ensure_buffers(torch.zeros(self.shape, device=self.pipe.device))
        firsts = {}
        steps = (plms_body_steps(self.pipe.sched) if self.plms
                 else sampler_steps(self.pipe.sampler.method, self.pipe.sched))
        for ti in steps:
            firsts.setdefault(self._branch(ti), ti)
        with torch.no_grad():
            for branch, ti in firsts.items():
                with at_model_step(self.pipe.sched.model_t_host(ti)):
                    self.buffers.t.fill_(ti)
                    if self.buffered:
                        self._graph(branch)()
                    else:
                        self.denoise(self.buffers.x, self.buffers.t)

    @torch.no_grad()
    def run(self, noise=None, generator=None, step_noise=None):
        """One sampling run, recorded as the span `sampler.run` (attr steps; a
        graph captured during the run is its child `graph.capture`)."""
        with tracing.span("sampler.run", steps=self.pipe.sched.num_timesteps):
            return self._run(noise, generator, step_noise)

    def _run(self, noise, generator, step_noise):
        pipe = self.pipe
        x = initial_x(self.shape, pipe.sched, generator, noise)
        steps = None if self.plms else sampler_steps(pipe.sampler.method, pipe.sched)
        if not self.buffered:
            if self.plms:
                return plms_eager_loop(self.step, x)
            return eager_loop(self.step, x, steps, generator, step_noise, pipe.sampler)
        self._ensure_buffers(x)
        checked = set()

        def run_step(_i, ti):
            branch = self._branch(ti)
            check = branch not in checked  # each graph's key, once a run
            checked.add(branch)
            return self._graph(branch)(check=check)

        if self.plms:
            return plms_run_on_buffers(run_step, self.buffers, self.step, x)
        return run_on_buffers(run_step, self.buffers, pipe.sched, x, steps, generator,
                              step_noise, pipe.sampler)


@dataclass
class SamplePipeline:
    """Callable sampler bound to a model apply_fn + diffusion setup.

    Runs on `device` ("cuda" unless the caller passes "cpu"); the schedule is
    moved there. On the card each sampling program (a shape, a guidance, a
    conditioning layout, an inpainting form) is kept and its sampler step
    replayed from CUDA graphs, one per branch of the apply_fn, all from one
    memory pool; `cuda_graphs=False` runs the same steps eagerly, for
    comparison. Runs stay eager by rule on the CPU and where the step runs
    autograd (reconstruction guidance, a `cond_loss_fn`).
    """

    apply_fn: Callable[..., torch.Tensor]  # (x, t, y, **obs) -> model out
    sched: DiffusionSchedule
    dcfg: DiffusionConfig
    sampler: SamplerConfig = SamplerConfig()
    device: str | torch.device = "cuda"
    cuda_graphs: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.sched = self.sched.to(self.device)
        self.programs: dict[Any, SamplingProgram] = {}
        self._pool = None

    def graph_pool(self):
        """The memory pool that every graph of this pipeline captures into."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def denoiser(
        self,
        y: dict[str, Any],
        guidance_param: float = 1.0,
        obs_x0: Optional[torch.Tensor] = None,
        obs_mask: Optional[torch.Tensor] = None,
    ):
        if guidance_param != 1.0:
            return make_cfg_denoiser(
                self.apply_fn, y, guidance_param, obs_x0=obs_x0, obs_mask=obs_mask
            )
        return make_plain_denoiser(self.apply_fn, y, obs_x0=obs_x0, obs_mask=obs_mask)

    def program(self, shape, y, guidance_param=1.0, obs_x0=None, obs_mask=None,
                inpaint=None, cond_loss_fn=None, cond_scale=1.0) -> SamplingProgram:
        """The program for these inputs' layout: kept on the card with graphs, made
        afresh otherwise (and for a run guided by `cond_loss_fn`, which runs
        eagerly); its buffers hold these inputs."""
        if cond_loss_fn is not None or not (self.cuda_graphs and self.device.type == "cuda"):
            return SamplingProgram(self, shape, y, guidance_param, obs_x0, obs_mask, inpaint,
                                   buffered=False, cond_loss_fn=cond_loss_fn,
                                   cond_scale=cond_scale)
        key = (tuple(shape), float(guidance_param),
               conditioning_signature(y, obs_x0, obs_mask), _inpaint_form(inpaint))
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = SamplingProgram(
                self, shape, y, guidance_param, obs_x0, obs_mask, inpaint, buffered=True)
        else:
            prog.load(y, obs_x0, obs_mask, inpaint)
        return prog

    def sample(
        self,
        shape: tuple[int, ...],
        y: dict[str, Any],
        guidance_param: float = 1.0,
        obs_x0: Optional[torch.Tensor] = None,
        obs_mask: Optional[torch.Tensor] = None,
        inpaint: Optional[InpaintingState] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        step_noise: Optional[Sequence[torch.Tensor]] = None,
        cond_loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        cond_scale: float = 1.0,
    ) -> torch.Tensor:
        """cond_loss_fn(pred_xstart, t_model): GMD-style guidance, the DDPM posterior
        mean shifted by variance x grad(-loss) x cond_scale (ddpm only)."""
        if cond_loss_fn is not None and self.sampler.method != "ddpm":
            # gradient guidance rides the DDPM posterior mean only
            raise ValueError("cond_loss_fn guidance requires the ddpm sampler")
        prog = self.program(shape, y, guidance_param, obs_x0, obs_mask, inpaint, cond_loss_fn,
                            cond_scale)
        return prog.run(noise, generator, step_noise)

    def sample_to_joints(
        self, features: torch.Tensor, denormalize: Callable[[torch.Tensor], torch.Tensor],
        abs_3d: bool,
    ) -> torch.Tensor:
        """Denormalized features → [B, T, 22, 3] joints (recover_from_ric)."""
        return recover_from_ric(denormalize(features), 22, abs_3d=abs_3d)
