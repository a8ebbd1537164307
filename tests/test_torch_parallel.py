"""parallel/ on torch.distributed against the JAX package and against one process,
on the CPU:

  * `fsdp_axis` (shard_params_fsdp's rule) picks JAX's axis for every leaf of a
    small MDM and UNet, at 2 and 4 ranks (min_size lowered so that most leaves
    qualify); `shard_batch` keeps the rank's rows, `shard_sample_inputs` only the
    batch-leading leaves;
  * two gloo processes (a FileStore in tmp_path, each run with its own timeout):
    `dp_sample` and `generate_eval_batch(mesh=)` equal one process within 1e-5
    and 1e-4 of the values' scale; a data-parallel train step (eager, and
    BufferedTrainStep on its buffers), 3 steps of the keyframe UNet and of MDM
    with dropout, equals the single-process step on the global batch: losses,
    parameters and EMA within 1e-5 of their scale, the buffered step equal to
    the eager one (MDM's attention key bias, whose gradient is rounding noise
    that AdamW turns into lr-sized steps, within 6 lr);
  * tp: MDM_TP_RULES / UNET_TP_RULES, `tp_spec_for_path`, the divisibility guard
    and each tp rank's chunk (`shard_params_tp`) equal JAX's for every leaf at tp
    2 and 4; four gloo processes at (dp, tp) = (2, 2): the Megatron-style
    forward of MDM and the keyframe UNet equals the full model within 1e-5, and
    three train steps equal the single-process step on the global batch (loss,
    grad_norm, param_norm within 1e-5; the last gradients within 5e-4 of each
    tensor's scale; parameters and EMA within 2e-4, torch_parallel_helpers.py
    says why).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from condmdi_tpu.models.mdm import MDM as JaxMDM
from condmdi_tpu.models.unet import MDM_UNET as JaxUNet
from condmdi_tpu.parallel import mesh as jmesh
from condmdi_tpu.parallel import tp as jtp
from condmdi_tpu_torch.parallel import mesh as tmesh
from condmdi_tpu_torch.parallel import tp as ttp
from condmdi_tpu_torch.parallel.dp_sample import shard_sample_inputs
from torch_parallel_helpers import run_ranks, sampling_ranks, tp_ranks, train_ranks

MIN_SIZE = 2**10


@functools.lru_cache(maxsize=None)
def jax_params(kind):
    B, T, F = 2, 24, 263
    x = jnp.zeros((B, T, F))
    t = jnp.zeros((B,), jnp.int32)
    y = {"text_embed": jnp.zeros((B, 512))}
    if kind == "unet":
        m = JaxUNet(njoints=F, latent_dim=32, dim_mults=(1, 2), keyframe_conditioned=True,
                    pad_frames_to=T)
        return m.init(jax.random.key(0), x, t, y, obs_x0=x, obs_mask=jnp.zeros((B, T, F), bool))
    return JaxMDM(njoints=F, latent_dim=64, ff_size=128, num_layers=2, num_heads=4).init(
        jax.random.key(0), x, t, y)


@pytest.mark.parametrize("kind", ["unet", "mdm"])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_axis_is_jax_choice(kind, n):
    params = jax_params(kind)
    mesh = jmesh.make_mesh(jax.devices()[:n])
    placed = jmesh.shard_params_fsdp(mesh, params, min_size=MIN_SIZE)
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    split = 0
    for path, leaf in leaves:
        spec = tuple(leaf.sharding.spec)
        want = spec.index(jmesh.DATA_AXIS) if jmesh.DATA_AXIS in spec else None
        got = tmesh.fsdp_axis(tuple(leaf.shape), n, MIN_SIZE)
        assert got == want, (jax.tree_util.keystr(path), leaf.shape, got, want)
        split += want is not None
    assert split >= 4  # the rule is exercised, not only its fallbacks


class _Mesh:
    """The two methods the placement helpers read, for one rank of n."""

    def __init__(self, rank, n):
        self.rank, self.n = rank, n

    def size(self):
        return self.n

    def get_local_rank(self):
        return self.rank


def test_shard_batch_and_sample_inputs_keep_the_rank_rows():
    batch = {"motion": torch.arange(24.).reshape(4, 6), "text": ["a", "b", "c", "d"],
             "lengths": np.arange(4), "scalar": 3}
    got = tmesh.shard_batch(_Mesh(1, 2), batch)
    assert torch.equal(got["motion"], batch["motion"][2:])
    np.testing.assert_array_equal(got["lengths"], [2, 3])
    assert got["text"] == batch["text"] and got["scalar"] == 3
    x, w = torch.zeros(4, 3), torch.ones(7)
    sx, sw, none = shard_sample_inputs(_Mesh(3, 4), 4, (x, w, None))
    assert sx.shape == (1, 3) and sw is w and none is None
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.rows_of(_Mesh(0, 3), 4)
    assert tmesh.fsdp_axis((8, 6), 2, min_size=100) is None  # under min_size
    assert tmesh.fsdp_axis((5, 7, 9), 2, min_size=1) is None  # no divisible axis


class _Mesh2D:
    """A ('dp', 'tp') mesh's tp axis, for tp rank r of n."""

    def __init__(self, rank, n):
        self.tp = _Mesh(rank, n)

    def __getitem__(self, name):
        assert name == ttp.TP_AXIS
        return self.tp


@pytest.mark.parametrize("kind", ["unet", "mdm"])
@pytest.mark.parametrize("n_tp", [2, 4])
def test_tp_rules_and_placement_are_jax(kind, n_tp):
    """Every leaf's spec (the rules, the divisibility guard) and every tp rank's chunk."""
    params = jax_params(kind)
    jrules, trules = ((jtp.UNET_TP_RULES, ttp.UNET_TP_RULES) if kind == "unet"
                      else (jtp.MDM_TP_RULES, ttp.MDM_TP_RULES))
    assert [(s, tuple(p)) for s, p in jrules] == list(trules)
    mesh = jtp.make_mesh_2d(8 // n_tp, n_tp)
    placed = jtp.shard_params_tp(mesh, params, rules=jrules)
    tree = jax.tree_util.tree_map(np.asarray, params)
    chunks = [ttp.shard_params_tp(_Mesh2D(r, n_tp), tree, rules=trules) for r in range(n_tp)]
    sharded = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        names = tuple(str(k.key) for k in path)
        want = tuple(leaf.sharding.spec)
        assert ttp.tp_spec_for_path(names, trules) == tuple(jtp.tp_spec_for_path(path, jrules))
        assert ttp.tp_placement(names, leaf.shape, n_tp, trules) == want, names
        sharded += ttp.TP_AXIS in want
        by_device = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for r in range(n_tp):
            node = chunks[r]
            for k in names:
                node = node[k]
            np.testing.assert_array_equal(node, by_device[mesh.devices[0, r]])
    assert sharded >= 6


def test_single_process_needs_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.initialize_distributed() is False
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh()


def test_data_parallel_sampling_equals_one_process(tmp_path):
    run_ranks(sampling_ranks, 2, str(tmp_path / "store"), 240.0)


def test_data_parallel_train_step_equals_one_process(tmp_path):
    run_ranks(train_ranks, 2, str(tmp_path / "store"), 240.0)


def test_tensor_parallel_step_equals_one_process(tmp_path):
    run_ranks(tp_ranks, 4, str(tmp_path / "store"), 300.0)
