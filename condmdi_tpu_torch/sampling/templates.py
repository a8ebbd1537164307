"""GMD guidance-mode presets (reference utils/generation_template.py:4-77).

Counterpart of condmdi_tpu/sampling/templates.py (pure Python over the
port's `replace_args`).

`get_template(args, name)` applies the per-mode flag bundle that the
reference's GMD sampler consumes (sample/gmd/generate.py:103): which
guidance loss to run, whether to impute the trajectory, whether generation
is two-stage (trajectory model -> motion model), and the point-to-point
imputation flavor.

The reference mutates the parsed args in place; here the presets are PURE:
`replace_args` returns a new args object (keeping the CLI-override
bookkeeping so checkpoint args.json merges can't clobber template-set or
user-set flags), so a single parsed config can spawn several preset variants.
"""

from __future__ import annotations

from condmdi_tpu_torch.utils.config import replace_args

TEMPLATE_NAMES = ("no", "mdm_legacy", "trajectory", "kps", "sdf", "testing")


def get_template(args, template_name: str = "no"):
    """Return a copy of `args` with the named preset applied.

    Mirrors reference utils/generation_template.py:4 (get_template): the
    mode names and every flag each mode sets are identical; unknown names
    raise with the valid choices listed (the reference raises a bare
    NotImplementedError).
    """
    if template_name == "no":
        return args
    fn = {
        "mdm_legacy": mdm_template,
        "trajectory": trajectory_template,
        "kps": kps_template,
        "sdf": sdf_template,
        "testing": testing_template,
    }.get(template_name)
    if fn is None:
        raise NotImplementedError(
            f"unknown generation template {template_name!r}; "
            f"choices: {', '.join(TEMPLATE_NAMES)}"
        )
    return fn(args)


def mdm_template(args):
    """Legacy MDM trajectory-imputing mode (generation_template.py:23-34):
    relative-root model, 6-second cut, single-stage, inpainting on."""
    return replace_args(
        args,
        motion_length=6.0,
        abs_3d=False,
        gen_two_stages=False,
        do_inpaint=True,
        guidance_mode="mdm_legacy",
    )


def trajectory_template(args):
    """Single-stage gradient guidance toward keyframe locations
    (generation_template.py:37-47)."""
    return replace_args(
        args,
        do_inpaint=True,
        guidance_mode="trajectory",
        gen_two_stages=False,
    )


def kps_template(args):
    """Two-stage keyframe-location guidance with point-to-point imputation
    (generation_template.py:50-59)."""
    return replace_args(
        args,
        do_inpaint=True,
        guidance_mode="kps",
        gen_two_stages=True,
        p2p_impute=True,
    )


def sdf_template(args):
    """Two-stage keyframe guidance + SDF obstacle avoidance
    (generation_template.py:62-67)."""
    return replace_args(
        args,
        do_inpaint=True,
        guidance_mode="sdf",
        gen_two_stages=True,
        p2p_impute=False,
    )


def testing_template(args):
    """Plain unguided sampling with everything off
    (generation_template.py:70-77)."""
    return replace_args(
        args,
        do_inpaint=False,
        guidance_mode="no",
        gen_two_stages=False,
        p2p_impute=False,
        use_ddim=False,
        interpolate_cond=False,
    )
