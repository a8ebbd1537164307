"""Text-to-motion sampling CLI (reference sample/synthesize.py:39).

Counterpart of condmdi_tpu/sampling/synthesize.py. Usage:

  python -m condmdi_tpu_torch.sampling.synthesize --model_path save/x/ckpt.npz \
      --text_prompt "a person walks forward" --num_samples 4

Runs on the card, in full float32 (no TF32); `main(argv, device="cpu")`
runs on the CPU. Text prompts come from --text_prompt, --input_text (a
file), or a default prompt. Writes
results.npy {motion, joints, text, lengths, num_samples, num_repetitions,
text_encoder} in --output_dir, as the JAX CLI does, and, best-effort, the
first sample's stick-figure video (sample00.mp4, or a GIF without ffmpeg;
viz/plot.py; the run says why where it skips it).

Checkpoints (`load_model_for_sampling`): a flat Flax `.npz` (as
scripts/gate_params_io.py exports one, e.g. the committed
save/synthetic_unet_m/gate_ema_000100000.npz) goes through
`weights.load_flax_params`; a reference `.pt` through the converters of
utils/checkpoint.py. An Orbax directory needs the JAX package to restore:
export it to a flat npz first. With no checkpoint, the model takes Flax's
initialisation from --seed, the weights the JAX CLI draws.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from condmdi_tpu_torch.device import float32_exact


def load_model_for_sampling(args, device: str | torch.device = "cuda"):
    """(model, sched, dcfg): the model built on `device` with its checkpoint's
    weights (or Flax's initialisation from args.seed), in eval mode and
    without parameter gradients, and the diffusion setup.

    When --model_path is set and an args.json sits next to the checkpoint,
    model/data/diffusion options are reloaded from it first, CLI flags
    winning (reference parse_and_load_from_model, parser_util.py:566-603);
    `args` is updated in place, as in the JAX CLI.
    """
    from condmdi_tpu_torch.models.factory import create_gaussian_diffusion, create_model
    from condmdi_tpu_torch.models.flax_init import load_flax_init, load_params
    from condmdi_tpu_torch.utils import checkpoint as ckpt
    from condmdi_tpu_torch.utils.config import load_args_from_model
    from condmdi_tpu_torch.weights import load_flax_params

    mp = getattr(args, "model_path", "")
    if mp and (Path(mp).parent / "args.json").exists():
        args = load_args_from_model(args, mp, cli_overridden=getattr(args, "_cli_overridden", ()))

    model = create_model(args, device)
    sched, dcfg = create_gaussian_diffusion(args)
    if mp and Path(mp).exists():
        if Path(mp).is_dir():
            raise ValueError(
                f"{mp} is an Orbax checkpoint directory, which only the JAX package can "
                "restore: export it to a flat npz (scripts/gate_params_io.py) and pass that"
            )
        if mp.endswith(".pt"):
            tree = ckpt.load_torch_checkpoint(
                mp, args.arch,
                **(dict(n_levels=len(args.dim_mults)) if args.arch.startswith("unet")
                   else dict(num_layers=args.layers)),
            )
            load_params(model, load_flax_params(tree))
        elif mp.endswith(".npz"):
            load_params(model, load_flax_params(mp))
        else:
            raise ValueError(f"unknown checkpoint format {mp!r}: a flat Flax .npz or a "
                             "reference .pt")
    else:
        load_flax_init(model, args.seed)
    model.requires_grad_(False).eval()
    return model, sched, dcfg


def model_apply_fn(model: torch.nn.Module):
    """The `apply_fn(x, t, y, **obs)` for SamplePipeline: keyframes reach a
    keyframe-conditioned model and are dropped for the others, which ignore
    them in the JAX package."""
    if getattr(model, "keyframe_conditioned", False):
        return model

    def apply_fn(x, t, y, **_):
        return model(x, t, y)

    return apply_fn


def get_text_prompts(args) -> list[str]:
    if getattr(args, "text_prompt", ""):
        return [args.text_prompt] * args.num_samples
    if getattr(args, "input_text", "") and Path(args.input_text).exists():
        lines = [line.strip() for line in Path(args.input_text).read_text().splitlines()
                 if line.strip()]
        return lines[: args.num_samples]
    return ["a person walks forward"] * args.num_samples


@float32_exact()
def main(argv=None, *, device: str | torch.device = "cuda"):
    from condmdi_tpu_torch.data.dataset import DatasetConfig, SyntheticMotionDataset
    from condmdi_tpu_torch.device import resolve_device
    from condmdi_tpu_torch.diffusion.sampling import SamplerConfig
    from condmdi_tpu_torch.models.text import encoder_name, make_text_encoder
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline
    from condmdi_tpu_torch.utils.config import GenerateArgs, parse_args

    args = parse_args(GenerateArgs, argv)
    dev = resolve_device(device)
    n_frames = min(args.num_frames, int(args.motion_length * 20))
    texts = get_text_prompts(args)
    B = len(texts)

    model, sched, dcfg = load_model_for_sampling(args, dev)
    F = model.input_feats

    encoder = make_text_encoder(args, device=dev)
    y = {"text_embed": torch.from_numpy(encoder.encode(texts)).to(dev)}
    pipe = SamplePipeline(model_apply_fn(model), sched, dcfg,
                          SamplerConfig(method="ddim" if args.use_ddim else "ddpm"), device=dev)

    all_motions, all_lengths = [], []
    for rep in range(args.num_repetitions):
        gen = torch.Generator(device=dev).manual_seed(args.seed + rep)
        all_motions.append(pipe.sample((B, n_frames, F), y, guidance_param=args.guidance_param,
                                       generator=gen))
        all_lengths.append(np.full((B,), n_frames))

    # denormalize + recover joints with the dataset's stats
    ds = SyntheticMotionDataset(DatasetConfig(max_motion_length=n_frames, abs_3d=args.abs_3d),
                                size=4, device=dev)
    joints = [pipe.sample_to_joints(m, ds.denormalize, args.abs_3d).cpu().numpy()
              for m in all_motions]

    out_dir = Path(args.output_dir or "save/synthesize_out")
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(
        out_dir / "results.npy",
        {
            "motion": np.concatenate([m.cpu().numpy() for m in all_motions], axis=0),
            "joints": np.concatenate(joints, axis=0),
            "text": texts * args.num_repetitions,
            "lengths": np.concatenate(all_lengths, axis=0),
            "num_samples": B,
            "num_repetitions": args.num_repetitions,
            "text_encoder": encoder_name(encoder),
        },
    )
    print(f"saved {out_dir/'results.npy'}")
    try:
        from condmdi_tpu_torch.viz.plot import save_stick_figure_video

        save_stick_figure_video(joints[0][0], out_dir / "sample00.mp4", title=texts[0])
    except Exception as e:  # viz is best-effort (ffmpeg or matplotlib may be absent)
        print(f"viz skipped: {e}")
    return out_dir


if __name__ == "__main__":
    main()
