"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points refuse to run quietly on the CPU.

The import check runs in a subprocess because this test process already
holds JAX (tests/conftest.py imports it).
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import elasticdl_tpu_torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(elasticdl_tpu_torch.__file__)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([_PKG], prefix="elasticdl_tpu_torch.")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "elasticdl_tpu_torch.serving.server" in mods
    assert "elasticdl_tpu_torch.ops.flash_attention" in mods
    # The job's modules: the copies and the ports.
    for name in (
        "chaos", "chaos.inject", "common.checkpoint", "common.config", "common.crashsan",
        "common.durable", "common.metrics", "common.racesan", "data.prefetch",
        "data.reader", "data.recordio", "data.synthetic", "master.evaluation_service",
        "master.fleet_metrics", "master.rendezvous", "master.servicer",
        "master.task_dispatcher", "serving.checkpoint_watcher", "worker.worker",
    ):
        assert f"elasticdl_tpu_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax') or m.split('.')[0] in ('jax', 'jaxlib') or m == 'elasticdl_tpu'"
        " or m.startswith('elasticdl_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|jaxlib|flax|optax|orbax|elasticdl_tpu)\b(?!_)"
    r"|from\s+(jax|jaxlib|flax|optax|orbax|elasticdl_tpu)\b(?!_))",
    re.M,
)


def test_source_scan_finds_no_jax_or_reference_import():
    offenders = []
    for root, _, files in os.walk(_PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for m in _IMPORT.finditer(f.read()):
                        offenders.append(f"{path}: {m.group(0).strip()}")
    assert not offenders, offenders
    assert _IMPORT.search("from elasticdl_tpu.common import rpc")
    assert not _IMPORT.search("from elasticdl_tpu_torch.common import rpc")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.serving.server import ServingServer
    from elasticdl_tpu_torch.worker.worker import Worker

    spec = transformer_lm.model_spec(vocab=32, dim=16, n_heads=2, n_layers=1, max_seq=8, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingServer(spec, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spec.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer_lm.params_from_jax({}, n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Worker(JobConfig(model_def="transformer_lm.model_spec"), master=None, reader=None,
               spec=spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingServer(spec, checkpoint_dir=str(tmp_path), max_batch=2)
    # Asked for explicitly, the CPU works.
    assert Trainer(spec, device="cpu").device.type == "cpu"
    worker = Worker(JobConfig(), master=None, reader=None, spec=spec, device="cpu")
    assert worker.trainer.device.type == "cpu"
