"""What a run of the benchmark loads: never JAX nor the JAX package,
compared by whole top-level module names (the port's name begins with the
JAX package's); and the references load nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import torch

import harness
from conftest import BENCH, ROOT


def test_the_chip_path_loads_no_jax():
    metrics = sorted(glob.glob(os.path.join(BENCH, "metrics", "*.py")))
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]",
        "import harness, job, check, readers, trace_reader, calibrate",
        "import families.transformer_lm, families.deepfm",
        "import torch.profiler",
        f"for path in {metrics!r}: harness._load_module(path, 'm_' + str(abs(hash(path))))",
        "print(sorted({m.split('.', 1)[0] for m in sys.modules} & set(harness.FORBIDDEN)))",
        "print('elasticdl_tpu_torch' in sys.modules)",
    ])
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_the_references_import_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "configs", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        tops = {n.split(".", 1)[0] for n in names}
        assert tops <= {"__future__", "math", "typing", "numpy", "torch", "configs"}, (path, tops)


def test_a_forbidden_module_stops_the_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {
        "numbers": [], "attempted": 1, "failed": 0, "metrics": {}, "device": {}})
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc = harness.main(["--workload", "gpt2s-train", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "elasticdl_tpu_torch_extra", type(sys)("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", type(sys)("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "elasticdl_tpu.ops", type(sys)("x"))
    assert harness.forbidden_modules() == ["elasticdl_tpu"]
