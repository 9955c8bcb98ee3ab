"""The repo's lint over the PyTorch port: ``tools/graftlint.py
elasticdl_tpu_torch`` reports nothing, so the port's ``# guarded-by:``,
``# single-writer:`` and lock-order annotations and its durable writes are
held from now on, and a repair undone shows up again (each mutation below
is one of the faults the lint once found in the port).
"""

import os
import subprocess
import sys

import pytest

from elasticdl_tpu.analysis.core import lint_text, run_lint
from elasticdl_tpu.analysis.durability import DurableWriteDisciplinePass
from elasticdl_tpu.analysis.lock_discipline import LockDisciplinePass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "elasticdl_tpu_torch")


def test_port_lints_clean():
    findings = run_lint([PORT], rel_to=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_cli_exits_zero_on_the_port():
    out = subprocess.run(
        [sys.executable, "tools/graftlint.py", "elasticdl_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout + out.stderr


def test_the_port_carries_its_lock_annotations():
    n = 0
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    n += f.read().count("# guarded-by:")
    assert n >= 109


# (file, text of the repair, the fault it repaired, the pass that finds it)
_UNDONE = [
    ("ps/host_store.py", "    def _live(self):  # guarded-by: _lock",
     "    def _live(self):", LockDisciplinePass, "lock-discipline"),
    ("common/checkpoint.py", "durable.atomic_replace(tmp, final)",
     "os.replace(tmp, final)", DurableWriteDisciplinePass, "durable-write-discipline"),
    ("serving/main.py", 'durable.atomic_publish(go_file + ".ready", str(os.getpid()))',
     'os.replace(go_file + ".tmp", go_file + ".ready")', DurableWriteDisciplinePass,
     "durable-write-discipline"),
    ("ops/kernels.py",
     "    # graftlint: allow[durable-write-discipline] a build product: a rename lost to "
     "a crash rebuilds it\n", "", DurableWriteDisciplinePass, "durable-write-discipline"),
    # The lock-free reader's waiver: every other read of ``_ptr`` holds the lock.
    ("ps/host_store.py",
     "        # graftlint: allow[lock-discipline] the lock-free reader: its caller's "
     "reader-writer lock (the PS service's per-table lock) keeps writers and close() out\n",
     "", LockDisciplinePass, "lock-discipline"),
]


@pytest.mark.parametrize("rel,repaired,fault,lint_pass,rule", _UNDONE,
                         ids=[u[0] for u in _UNDONE[:-1]] + ["ps/host_store.py::try_pull"])
def test_an_undone_repair_is_found_again(rel, repaired, fault, lint_pass, rule):
    path = os.path.join(PORT, rel)
    with open(path) as f:
        text = f.read()
    assert text.count(repaired) == 1, repaired
    display = os.path.relpath(path, REPO)
    assert lint_text(text, [lint_pass()], path=display) == []
    findings = lint_text(text.replace(repaired, fault), [lint_pass()], path=display)
    assert findings and {f.rule for f in findings} == {rule}, [f.render() for f in findings]
