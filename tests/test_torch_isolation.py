"""condmdi_tpu_torch stands alone: none of its modules, nor chip_smoke.py,
imports JAX, Flax or the JAX package; importing it loads neither; and its entry
points default to CUDA and raise where there is none, instead of running on
the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "condmdi_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "condmdi_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "attention_probe.py",
                                        REPO / "int8_probe.py", REPO / "resblock_probe.py",
                                        REPO / "eval_protocol.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import condmdi_tpu_torch, condmdi_tpu_torch.serving, condmdi_tpu_torch.weights\n"
        "import condmdi_tpu_torch.sampling.pipeline, condmdi_tpu_torch.ops.resblock\n"
        "import condmdi_tpu_torch.ops.attention, condmdi_tpu_torch.models.mdm\n"
        "import condmdi_tpu_torch.models.dit, condmdi_tpu_torch.models.text\n"
        "import condmdi_tpu_torch.ops.quant, condmdi_tpu_torch.bench\n"
        "import condmdi_tpu_torch.models.factory, condmdi_tpu_torch.models.flax_init\n"
        "import condmdi_tpu_torch.utils.config, condmdi_tpu_torch.utils.checkpoint\n"
        "import condmdi_tpu_torch.data.layout, condmdi_tpu_torch.data.humanml_repr\n"
        "import condmdi_tpu_torch.data.dataset, condmdi_tpu_torch.data.fixed_dataset\n"
        "import condmdi_tpu_torch.geometry.quaternion, condmdi_tpu_torch.geometry.skeleton\n"
        "import condmdi_tpu_torch.training.keyframes, condmdi_tpu_torch.sampling.templates\n"
        "import condmdi_tpu_torch.sampling.synthesize, condmdi_tpu_torch.sampling.conditional\n"
        "import condmdi_tpu_torch.sampling.edit, condmdi_tpu_torch.evals\n"
        "import condmdi_tpu_torch.evals.metrics, condmdi_tpu_torch.evals.evaluator\n"
        "import condmdi_tpu_torch.evals.train_evaluator, condmdi_tpu_torch.evals.common\n"
        "import condmdi_tpu_torch.evals.harness, condmdi_tpu_torch.evals.run\n"
        "import condmdi_tpu_torch.evals.run_t2m, condmdi_tpu_torch.data.convert\n"
        "import condmdi_tpu_torch.data.word_vectorizer, condmdi_tpu_torch.utils.seed\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'condmdi_tpu')]\n"
        "assert not bad, bad\n"
        "from condmdi_tpu_torch.ops import _build\n"
        "assert _build._libs == {}, 'a kernel was built at import'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")


def test_model_defaults_to_cuda_and_raises_without_it():
    _needs_no_cuda()
    from condmdi_tpu_torch.models.unet import MDM_UNET

    with pytest.raises(RuntimeError, match="CUDA"):
        MDM_UNET(latent_dim=16, dim_mults=(1, 2), pad_frames_to=24)


@pytest.mark.parametrize("model", ["MDM", "MDM_DiT"])
def test_transformer_models_default_to_cuda_and_raise_without_it(model):
    _needs_no_cuda()
    from condmdi_tpu_torch.models.dit import MDM_DiT
    from condmdi_tpu_torch.models.mdm import MDM

    cls = {"MDM": MDM, "MDM_DiT": MDM_DiT}[model]
    with pytest.raises(RuntimeError, match="CUDA"):
        cls(latent_dim=16, ff_size=32, num_layers=1, num_heads=2)


def test_pipeline_and_server_default_to_cuda_and_raise_without_it():
    _needs_no_cuda()
    from condmdi_tpu_torch.diffusion import (
        DiffusionConfig, DiffusionSchedule, get_named_beta_schedule,
    )
    from condmdi_tpu_torch.sampling.pipeline import SamplePipeline

    sched = DiffusionSchedule.create(get_named_beta_schedule("cosine", 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        SamplePipeline(lambda *a, **k: None, sched, DiffusionConfig())


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    """Without the package beside it (or without CUDA) it exits non-zero and
    prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
