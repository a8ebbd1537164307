"""The port's configuration, presets, checkpoint converters and model factory
against the JAX package's, on the CPU.

  * utils/config.py: the same argv parses to the same args (values and the
    CLI-override bookkeeping), and args.json written by either framework is
    the same file and loads back the same way;
  * sampling/templates.py: every preset sets the same fields;
  * utils/checkpoint.py: the reference-layout state dicts the test writes
    (from a Flax tree, by the inverse of the converters' layouts) convert to
    the same Flax tree, equal to the array, and that tree loads into the
    port's model;
  * models/factory.py: the diffusion setup's tables equal JAX's to float32
    rounding (1e-6 relative), and the Flax initialisation replayed from a
    seed equals `model.init(jax.random.key(seed))` at 1e-6 relative, for the
    keyframe-conditioned UNet and for MDM trans_enc, as the CLIs build them.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.models import factory as jfactory
from condmdi_tpu.sampling import templates as jtemplates
from condmdi_tpu.utils import checkpoint as jckpt
from condmdi_tpu.utils import config as jconfig
from condmdi_tpu_torch.models import factory as tfactory
from condmdi_tpu_torch.models.flax_init import flax_params
from condmdi_tpu_torch.sampling import templates as ttemplates
from condmdi_tpu_torch.utils import checkpoint as tckpt
from condmdi_tpu_torch.utils import config as tconfig
from condmdi_tpu_torch.weights import load_flax_params

ARGVS = [
    [],
    ["--edit_mode", "random_joints", "--imputate", "true", "--dim_mults", "1", "2", "2",
     "--reconstruction_weight", "0.5", "--gradient_schedule", "linear", "--seed", "3"],
    ["--config", "motion_abs_unet_adagn_xl", "--num_samples", "4", "--use_ddim", "yes",
     "--timestep_respacing", "ddim20", "--precision_mode", "int8", "--unknown_flag", "7"],
]


def _fields(args):
    return dataclasses.asdict(args), sorted(getattr(args, "_cli_overridden", ()))


@pytest.mark.parametrize("cls", ["CondSyntArgs", "GenerateArgs", "EvalArgs", "TrainArgs",
                                 "GMDGenerateArgs"])
@pytest.mark.parametrize("argv", range(len(ARGVS)))
def test_parse_args_equals_jax(cls, argv):
    got = tconfig.parse_args(getattr(tconfig, cls), ARGVS[argv])
    want = jconfig.parse_args(getattr(jconfig, cls), ARGVS[argv])
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)


def test_constants_equal_jax():
    assert tconfig.EDIT_MODES == jconfig.EDIT_MODES
    assert sorted(tconfig.CARDS) == sorted(jconfig.CARDS)
    for name in tconfig.CARDS:
        assert dataclasses.asdict(tconfig.CARDS[name]()) == dataclasses.asdict(jconfig.CARDS[name]())


def test_args_json_round_trip_equals_jax(tmp_path):
    argv = ARGVS[1] + ["--latent_dim", "96", "--abs_3d", "true"]
    tconfig.save_args_json(tconfig.parse_args(tconfig.TrainArgs, argv), tmp_path / "t" / "args.json")
    jconfig.save_args_json(jconfig.parse_args(jconfig.TrainArgs, argv), tmp_path / "j" / "args.json")
    assert (tmp_path / "t" / "args.json").read_text() == (tmp_path / "j" / "args.json").read_text()
    # loading it: model/data/diffusion options from the file, CLI-set names kept
    cli = ["--num_frames", "60", "--seed", "5"]
    got = tconfig.parse_args(tconfig.CondSyntArgs, cli)
    got = tconfig.load_args_from_model(got, tmp_path / "t" / "ckpt.npz", got._cli_overridden)
    want = jconfig.parse_args(jconfig.CondSyntArgs, cli)
    want = jconfig.load_args_from_model(want, tmp_path / "j" / "ckpt", want._cli_overridden)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.latent_dim == 96 and got.num_frames == 60 and got.dim_mults == (1.0, 2.0, 2.0)
    with pytest.raises(FileNotFoundError):
        tconfig.load_args_from_model(got, tmp_path / "none" / "ckpt.npz")


def test_replace_args_keeps_override_bookkeeping():
    base = tconfig.parse_args(tconfig.GMDGenerateArgs, ["--seed", "4"])
    new = tconfig.replace_args(base, guidance_mode="kps", do_inpaint=True)
    want = jconfig.replace_args(jconfig.parse_args(jconfig.GMDGenerateArgs, ["--seed", "4"]),
                                guidance_mode="kps", do_inpaint=True)
    assert _fields(new) == _fields(want)


@pytest.mark.parametrize("name", jtemplates.TEMPLATE_NAMES)
def test_templates_equal_jax(name):
    got = ttemplates.get_template(tconfig.parse_args(tconfig.GMDGenerateArgs, []), name)
    want = jtemplates.get_template(jconfig.parse_args(jconfig.GMDGenerateArgs, []), name)
    assert _fields(got) == _fields(want)
    with pytest.raises(NotImplementedError, match="choices"):
        ttemplates.get_template(got, "sideways")


# --------------------------------------------------------------------------- #
# the .pt converters
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): np.asarray(v)})
    return out


def _lin(sd, key, p):
    sd[key + ".weight"], sd[key + ".bias"] = np.asarray(p["kernel"]).T.copy(), np.asarray(p["bias"])


def _conv(sd, key, p, transpose=False):
    k = np.asarray(p["kernel"])
    # Conv: flax [k, in, out] -> torch [out, in, k]; ConvTranspose: flipped along k -> [in, out, k]
    sd[key + ".weight"] = (k[::-1].transpose(1, 2, 0) if transpose else k.transpose(2, 1, 0)).copy()
    sd[key + ".bias"] = np.asarray(p["bias"])


def _norm(sd, key, p):
    sd[key + ".weight"], sd[key + ".bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])


def _ref_unet_sd(params, n_levels):
    """The reference MDM_UNET state dict holding `params` (the converters' inverse)."""
    sd = {}
    _lin(sd, "embed_timestep.time_embed.0", params["embed_timestep"]["fc1"])
    _lin(sd, "embed_timestep.time_embed.2", params["embed_timestep"]["fc2"])
    _lin(sd, "embed_text", params["embed_text"])
    u = params["unet"]
    _lin(sd, "unet.time_mlp.0", u["time_fc1"])
    _lin(sd, "unet.time_mlp.2", u["time_fc2"])

    def res(pre, p):
        _lin(sd, f"{pre}.time_mlp.1", p["time_mlp"])
        _conv(sd, f"{pre}.blocks.0.block1.0", p["block1"]["conv"])
        _norm(sd, f"{pre}.blocks.0.block1.2", p["block1"]["norm"])
        _conv(sd, f"{pre}.blocks.1.block.0", p["block2"]["conv"])
        _norm(sd, f"{pre}.blocks.1.block.2", p["block2"]["norm"])
        if "residual_conv" in p:
            _conv(sd, f"{pre}.residual_conv", p["residual_conv"])

    for i in range(n_levels):
        res(f"unet.downs.{i}.0", u[f"down{i}_res1"])
        res(f"unet.downs.{i}.1", u[f"down{i}_res2"])
        if f"down{i}_downsample" in u:
            _conv(sd, f"unet.downs.{i}.3.conv", u[f"down{i}_downsample"])
    res("unet.mid_block1", u["mid_block1"])
    res("unet.mid_block2", u["mid_block2"])
    for i in range(n_levels - 1):
        res(f"unet.ups.{i}.0", u[f"up{i}_res1"])
        res(f"unet.ups.{i}.1", u[f"up{i}_res2"])
        if f"up{i}_upsample" in u:
            _conv(sd, f"unet.ups.{i}.3.conv", u[f"up{i}_upsample"], transpose=True)
    _conv(sd, "unet.final_conv.0.block.0", u["final_block"]["conv"])
    _norm(sd, "unet.final_conv.0.block.2", u["final_block"]["norm"])
    _conv(sd, "unet.final_conv.1", u["final_conv"])
    return sd


def _ref_mdm_sd(params, num_layers):
    sd = {}
    _lin(sd, "input_process.poseEmbedding", params["input_process"])
    _lin(sd, "output_process.poseFinal", params["output_process"])
    _lin(sd, "embed_timestep.time_embed.0", params["embed_timestep"]["fc1"])
    _lin(sd, "embed_timestep.time_embed.2", params["embed_timestep"]["fc2"])
    _lin(sd, "embed_text", params["embed_text"])
    for i in range(num_layers):
        pre, p = f"seqTransEncoder.layers.{i}", params[f"layer{i}"]
        sd[f"{pre}.self_attn.in_proj_weight"] = np.asarray(p["qkv"]["kernel"]).T.copy()
        sd[f"{pre}.self_attn.in_proj_bias"] = np.asarray(p["qkv"]["bias"])
        _lin(sd, f"{pre}.self_attn.out_proj", p["attn_out"])
        _lin(sd, f"{pre}.linear1", p["ff1"])
        _lin(sd, f"{pre}.linear2", p["ff2"])
        _norm(sd, f"{pre}.norm1", p["norm1"])
        _norm(sd, f"{pre}.norm2", p["norm2"])
    return sd


B, T, F = 1, 24, 263


def _jax_init(arch, seed=0):
    """(JAX params, CLI args) of a small model as the CLIs build it."""
    argv = (["--arch", "unet", "--latent_dim", "16", "--dim_mults", "1", "2", "--unet_pad_to", "24",
             "--keyframe_conditioned", "true", "--unet_zero", "false"] if arch == "unet" else
            ["--latent_dim", "32", "--ff_size", "64", "--layers", "2"])
    args = jconfig.parse_args(jconfig.CondSyntArgs, argv + ["--seed", str(seed)])
    model = jfactory.create_model(args)
    x, t, y = jnp.zeros((B, T, F)), jnp.zeros((B,), jnp.int32), {"text_embed": jnp.zeros((B, 512))}
    kw = dict(obs_x0=x, obs_mask=jnp.zeros((B, T, F), bool)) if arch == "unet" else {}
    params = model.init(jax.random.key(seed), x, t, y, **kw)
    return jax.tree_util.tree_map(np.asarray, params)["params"], tconfig.parse_args(
        tconfig.CondSyntArgs, argv + ["--seed", str(seed)])


@pytest.mark.parametrize("arch", ["unet", "trans_enc"])
def test_pt_converters_equal_jax_and_load_into_the_port(arch, tmp_path):
    params, args = _jax_init(arch)
    # perturbed, so that every leaf (zero biases, unit scales) is distinct
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32), params)
    if arch == "unet":
        sd, kw = _ref_unet_sd(params, 2), dict(n_levels=2)
    else:
        sd, kw = _ref_mdm_sd(params, 2), dict(num_layers=2)
    got = (tckpt.convert_unet_state_dict if arch == "unet" else tckpt.convert_mdm_state_dict)(sd, **kw)
    want = (jckpt.convert_unet_state_dict if arch == "unet" else jckpt.convert_mdm_state_dict)(sd, **kw)
    assert _flat(got).keys() == _flat(want).keys() == _flat({"params": params}).keys()
    for key, value in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[key], value)
        np.testing.assert_array_equal(value, _flat({"params": params})[key])
    # through a .pt file with model_avg and a CLIP key, as the reference saves them
    path = tmp_path / "model000001.pt"
    torch.save({"model": {}, "model_avg": {**{k: torch.from_numpy(v) for k, v in sd.items()},
                                            "clip_model.x": torch.zeros(1)}}, path)
    loaded = tckpt.load_torch_checkpoint(path, args.arch, **kw)
    for key, value in _flat(want).items():
        np.testing.assert_array_equal(_flat(loaded)[key], value)
    model = tfactory.create_model(args, "cpu")
    model.load_state_dict(load_flax_params(loaded))  # strict: the tree covers the model


def test_select_eval_params_equals_jax():
    p, e = {"w": np.ones(2)}, {"w": np.zeros(2)}
    for restored in ({"params": p, "ema_params": e}, {"params": p, "ema_params": None},
                     {"params": {"params": p}}):
        for use_ema in (True, False):
            assert tckpt.select_eval_params(restored, use_ema) == jckpt.select_eval_params(restored, use_ema)


# --------------------------------------------------------------------------- #
# the factory
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("argv", [[], ["--use_ddim", "true"], ["--timestep_respacing", "ddim25",
                                                                "--sigma_small", "false",
                                                                "--predict_xstart", "false"]])
def test_gaussian_diffusion_equals_jax(argv):
    tsched, tcfg = tfactory.create_gaussian_diffusion(tconfig.parse_args(tconfig.CondSyntArgs, argv))
    jsched, jcfg = jfactory.create_gaussian_diffusion(jconfig.parse_args(jconfig.CondSyntArgs, argv))
    assert tcfg.model_mean_type.name == jcfg.model_mean_type.name
    assert tcfg.model_var_type.name == jcfg.model_var_type.name
    assert tcfg.clip_range == jcfg.clip_range
    assert tsched.num_timesteps == jsched.num_timesteps
    np.testing.assert_array_equal(np.asarray(tsched.timestep_map), np.asarray(jsched.timestep_map))
    for name in ("betas", "alphas_cumprod", "posterior_log_variance_clipped"):
        np.testing.assert_allclose(getattr(tsched, name).numpy(), np.asarray(getattr(jsched, name)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["unet", "trans_enc"])
def test_flax_init_from_the_seed_equals_jax(arch):
    want, args = _jax_init(arch, seed=10)
    got = flax_params(tfactory.create_model(args, "cpu"), 10)
    want = _flat(want)
    assert set(got) == set(want)
    for key, value in want.items():
        scale = np.abs(value).max() + 1e-12
        assert np.abs(got[key].numpy() - value).max() <= 1e-6 * scale, key


def test_unported_options_raise():
    """--unet_attention, once refused, builds the UNet with its LinearAttention
    blocks (parity: tests/test_torch_model_variants.py); the model dims follow JAX's."""
    args = tconfig.parse_args(tconfig.CondSyntArgs, ["--arch", "unet", "--unet_attention", "true"])
    model = tfactory.create_model(args, "cpu")
    assert model.unet.attention and hasattr(model.unet, "mid_attn")
    assert tfactory.get_model_dims(args) == jfactory.get_model_dims(args)
    assert json.dumps(tfactory.get_model_dims(tconfig.parse_args(
        tconfig.CondSyntArgs, ["--traj_only", "true"]))) == json.dumps(
        jfactory.get_model_dims(jconfig.parse_args(jconfig.CondSyntArgs, ["--traj_only", "true"])))
