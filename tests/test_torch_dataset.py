"""The port's synthetic dataset, collation, fixed-dataset fixtures and the
HumanML3D loader's existence test against the JAX package's, on the CPU.

Same seeds, same items: captions, tokens, lengths, time masks and text
embeddings equal; the normalised motions within DATA_ATOL = 1e-4 absolute
(measured 2.6e-5: the two float32 codecs' 1e-5 feature differences divided
by the population std; tests/test_torch_data.py holds the codec itself).
"""

import numpy as np
import pytest
import torch

from condmdi_tpu.data import dataset as jds
from condmdi_tpu.data import fixed_dataset as jfixed
from condmdi_tpu.models.text import HashTextEncoder as JaxHash
from condmdi_tpu.models.text import encoder_name as jax_encoder_name
from condmdi_tpu_torch.data import dataset as tds
from condmdi_tpu_torch.data import fixed_dataset as tfixed
from condmdi_tpu_torch.models.text import CachedTextEncoder, HashTextEncoder, encoder_name

DATA_ATOL = 1e-4


@pytest.mark.parametrize("abs_3d", [True, False])
def test_synthetic_dataset_and_collate_equal_jax(abs_3d):
    n, T = 6, 120
    jcfg = jds.DatasetConfig(max_motion_length=T, abs_3d=abs_3d, split="test")
    tcfg = tds.DatasetConfig(max_motion_length=T, abs_3d=abs_3d, split="test")
    jset = jds.SyntheticMotionDataset(jcfg, size=n, seed=3)
    tset = tds.SyntheticMotionDataset(tcfg, size=n, seed=3, device="cpu")
    assert [it["texts"] for it in tset.items] == [it["texts"] for it in jset.items]
    np.testing.assert_array_equal(tset.stats.mean, jset.stats.mean)
    np.testing.assert_array_equal(tset.stats.std, jset.stats.std)
    np.random.seed(11)
    want = jds.collate([jset[i] for i in range(n)], T, JaxHash())
    np.random.seed(11)
    got = tds.collate([tset[i] for i in range(n)], T, HashTextEncoder())
    assert got.keys() == want.keys()
    for key in ("text", "tokens"):
        assert got[key] == want[key]
    for key in ("lengths", "time_mask", "text_embed"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["motion"], want["motion"], rtol=0, atol=DATA_ATOL)
    m = torch.from_numpy(got["motion"])
    np.testing.assert_allclose(tset.denormalize(m).numpy(), jset.denormalize(got["motion"]),
                               rtol=1e-6, atol=1e-6)


def test_fixed_dataset_fixture_and_round_trip_equal_jax(tmp_path):
    np.random.seed(7)  # the fixture's crops and captions come from np.random
    want = jfixed.load_fixed_dataset(5, jfixed.make_synthetic_fixture(tmp_path / "j.npz", n=4, T=60),
                                     text_encoder=JaxHash())
    np.random.seed(7)
    path = tfixed.make_synthetic_fixture(tmp_path / "t.npz", n=4, T=60, device="cpu")
    got = tfixed.load_fixed_dataset(5, path, text_encoder=HashTextEncoder())
    assert got["text"] == want["text"]
    for key in ("lengths", "time_mask", "text_embed"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["motion"], want["motion"], rtol=0, atol=DATA_ATOL)
    # the port's file reads back bit for bit, in both frameworks
    again = tfixed.save_fixed_dataset(got, tmp_path / "again.npz")
    for loader in (tfixed.load_fixed_dataset, jfixed.load_fixed_dataset):
        back = loader(5, again)
        np.testing.assert_array_equal(back["motion"], got["motion"])
        assert back["text"] == got["text"]
    with pytest.raises(FileNotFoundError):
        tfixed.load_fixed_dataset(1, tmp_path / "none.npz")


def test_text2motion_guard(tmp_path):
    """FileNotFoundError without the split file, where JAX raises it (the
    callers' cue to fall back to the synthetic set); with the files, the port
    reads the same entries as JAX (tests/test_torch_real_datasets.py holds the
    items)."""
    cfg = tds.DatasetConfig(data_dir=str(tmp_path), split="test")
    with pytest.raises(FileNotFoundError):
        jds.Text2MotionDataset(jds.DatasetConfig(data_dir=str(tmp_path), split="test"))
    with pytest.raises(FileNotFoundError):
        tds.Text2MotionDataset(cfg)
    (tmp_path / "test.txt").write_text("000001\n")
    (tmp_path / "new_joint_vecs").mkdir()
    (tmp_path / "texts").mkdir()
    np.save(tmp_path / "new_joint_vecs" / "000001.npy", np.zeros((60, 263), np.float32))
    (tmp_path / "texts" / "000001.txt").write_text("a person walks#a/DET person/NOUN##\n")
    identity = tds.NormStats(np.zeros(263, np.float32), np.ones(263, np.float32))
    got = tds.Text2MotionDataset(cfg, stats=identity)
    want = jds.Text2MotionDataset(jds.DatasetConfig(data_dir=str(tmp_path), split="test"),
                                  stats=identity)
    assert got.entries == want.entries and len(got) == 1


def test_encoder_name_equals_jax(tmp_path):
    np.savez(tmp_path / "e.npz", captions=np.asarray(["a"], dtype=object),
             embeddings=np.zeros((1, 512), np.float32))
    assert encoder_name(HashTextEncoder()) == jax_encoder_name(JaxHash()) == "hash"
    assert encoder_name(CachedTextEncoder.from_npz(str(tmp_path / "e.npz"))) == "cached"
