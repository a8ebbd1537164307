"""The training data feed and the evaluator's trainer against the JAX package, on the CPU.

  * DataLoader batches (shuffle, shard, crop and caption draws from the
    global np.random) against JAX's for the same seeds: indices, lengths,
    masks and captions equal, motions within 1e-4 absolute (the synthetic
    features are computed in each framework, tests/test_torch_dataset.py);
    `batches(epoch, start)` resumes the stream where it stopped;
  * apply_augmentation against JAX's under the same global seed, exactly;
  * PrefetchIterator keeps the order, surfaces the feeder's error, and
    close() stops its thread;
  * get_dataset_loader's size rule, and the synthetic set's disk cache for
    512 items or more (written once, read back equal);
  * evals.train_evaluator.train against JAX's for 3 steps: each logged loss
    within 1e-3 relative (the features differ by 1e-4, the contrastive loss
    goes through three encoders and two Adam updates).
"""

import numpy as np
import pytest

from condmdi_tpu.data import dataset as jd
from condmdi_tpu_torch.data import dataset as td
from torch_eval_helpers import few_torch_threads  # noqa: F401 (module fixture)

DATA_ATOL = 1e-4


def loaders(seed=3, size=24, batch=4, T=20, **kw):
    jcfg = jd.DatasetConfig(max_motion_length=T, abs_3d=True)
    tcfg = td.DatasetConfig(max_motion_length=T, abs_3d=True)
    jl = jd.DataLoader(jd.SyntheticMotionDataset(jcfg, size=size, seed=seed), batch, T,
                       seed=seed, **kw)
    tl = td.DataLoader(td.SyntheticMotionDataset(tcfg, size=size, seed=seed, device="cpu"),
                       batch, T, seed=seed, **kw)
    return jl, tl


def assert_batches_equal(got, want):
    for k in ("lengths", "time_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["text"] == want["text"]
    np.testing.assert_allclose(got["motion"], want["motion"], rtol=0, atol=DATA_ATOL)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_dataloader_batches_equal_jax(shard):
    jl, tl = loaders(process_index=shard[0], process_count=shard[1])
    assert len(jl) == len(tl)
    np.random.seed(11)
    want = [b for _ in range(2) for b in jl]  # two epochs
    np.random.seed(11)
    got = [b for _ in range(2) for b in tl]
    assert len(got) == len(want) == 2 * len(jl)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_dataloader_resumes_at_a_position():
    """From (epoch, batch) and the global numpy state after the last batch read,
    the stream goes on as it would have, across an epoch's end too."""
    _, tl = loaders(size=20)  # 5 batches of 4 an epoch
    np.random.seed(5)
    stream = tl.batches()
    read, states = [], []
    for _ in range(7):
        read.append(next(stream))
        states.append(np.random.get_state())
    assert [pos for _, pos in read] == [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (1, 1), (1, 2)]
    for i in (1, 4):  # resume after the 2nd batch, and after the epoch's last
        np.random.set_state(states[i])
        batch, pos = next(tl.batches(*read[i][1]))
        assert pos == read[i + 1][1]
        assert_batches_equal(batch, read[i + 1][0])


def test_apply_augmentation_equals_jax():
    m = np.random.default_rng(0).standard_normal((30, 263)).astype(np.float32)
    for kind in ("none", "rot", "full"):
        np.random.seed(2)
        want = jd.apply_augmentation(m, kind)
        np.random.seed(2)
        got = td.apply_augmentation(m, kind)
        np.testing.assert_array_equal(got, want)


def test_prefetch_iterator_order_errors_and_close():
    assert list(td.PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise ValueError("feeder failed")

    it = td.PrefetchIterator(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="feeder failed"):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = td.PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not it._thread.is_alive()


def test_get_dataset_loader_size_rule(monkeypatch, tmp_path):
    cfg = td.DatasetConfig(data_dir=str(tmp_path / "absent"), max_motion_length=16)
    monkeypatch.delenv("CONDMDI_SYNTHETIC_SIZE", raising=False)
    assert len(td.get_dataset_loader(cfg, 5, device="cpu").dataset) == 64  # max(4B, 64)
    assert len(td.get_dataset_loader(cfg, 20, device="cpu").dataset) == 80
    monkeypatch.setenv("CONDMDI_SYNTHETIC_SIZE", "40")
    assert len(td.get_dataset_loader(cfg, 20, device="cpu").dataset) == 40
    cfg.synthetic_size = 33
    assert len(td.get_dataset_loader(cfg, 20, device="cpu").dataset) == 33
    jcfg = jd.DatasetConfig(data_dir=str(tmp_path / "absent"), max_motion_length=16,
                            synthetic_size=33)
    assert len(jd.get_dataset_loader(jcfg, 20).dataset) == 33


def test_synthetic_disk_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("CONDMDI_SYNTH_CACHE", str(tmp_path))
    cfg = td.DatasetConfig(max_motion_length=8, abs_3d=True)
    a = td.SyntheticMotionDataset(cfg, size=512, seed=4, device="cpu")
    files = list((tmp_path / "torch").glob("synth_1_9_4_512_cpu.npz"))
    assert len(files) == 1
    small = td.SyntheticMotionDataset(cfg, size=8, seed=4, device="cpu")  # below 512: no file
    assert len(small) == 8 and len(list((tmp_path / "torch").iterdir())) == 1
    calls = []
    from condmdi_tpu_torch.data import humanml_repr

    monkeypatch.setattr(humanml_repr, "extract_features",
                        lambda *a, **k: calls.append(1) or None)
    b = td.SyntheticMotionDataset(cfg, size=512, seed=4, device="cpu")
    assert calls == []  # read from the cache, not made again
    for i in (0, 100, 511):
        np.testing.assert_array_equal(a.items[i]["motion"], b.items[i]["motion"])
        assert a.items[i]["texts"] == b.items[i]["texts"]


def test_train_evaluator_matches_jax(tmp_path):
    from condmdi_tpu.evals import train_evaluator as jt
    from condmdi_tpu_torch.evals import train_evaluator as tt

    argv = ["--steps", "3", "--batch_size", "6", "--train_size", "12", "--val_size", "32",
            "--val_batches", "1", "--num_frames", "16", "--seed", "2", "--log_every", "1"]
    np.random.seed(9)  # the items' crop and caption draws (global numpy, as in JAX)
    want = jt.main(argv + ["--out", str(tmp_path / "jax")])
    np.random.seed(9)
    got = tt.main(argv + ["--out", str(tmp_path / "torch")], device="cpu")
    assert [r["step"] for r in got["log"]] == [r["step"] for r in want["log"]] == [0, 1, 2]
    for g, w in zip(got["log"], want["log"]):
        for k in ("loss", "loss_pos", "loss_neg"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
    assert (tmp_path / "torch" / "evaluator.npz").exists()
    tree = tt.load_params_npz(tmp_path / "torch" / "evaluator.npz")
    ref = jt.load_params_npz(tmp_path / "jax" / "evaluator.npz")
    assert set(tree) == set(ref) and set(tree["motion"]) == set(ref["motion"])
