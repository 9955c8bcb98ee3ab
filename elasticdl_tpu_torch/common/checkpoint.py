"""Checkpoint save/restore of the PyTorch port, without Orbax.

Port of ``elasticdl_tpu/common/checkpoint.py``.  The manifest half is the
reference's, field for field (``MANIFEST_NAME``, ``publish_manifest``,
``read_manifest``), so each package's reader reads the other's manifest.
The store half replaces Orbax:

- A checkpoint is the trainer's CANONICAL state (``Trainer.host_state``):
  a flat ``{path: numpy array}`` dict — the parameters under their JAX
  parameter-tree paths, the AdamW moments under the same paths, the
  optimizer count and the step.  It restores into any trainer of the same
  model through ``Trainer.adopt_restored``.

Format contract (the reference's, r11): the stored layout never depends on
the world that wrote it.  Tables are stored whole, never a rank's rows;
optimizer moments param-shaped, never the sharded optimizer's flat
``[padded / n]`` shards.  Writers go through ``Trainer.host_state`` or
``Trainer.snapshot_state`` (with sharded state a collective that gathers
the rows and the shards, so every rank of a gang calls it and rank 0
writes); readers go through ``Trainer.restore_template`` and
``adopt_restored``, which slice the canonical arrays into whatever layout
the live mesh runs and refuse any other shape.  So a checkpoint of a
two-rank sharded job restores into a world of one, and back, with its
moments carried, never re-initialised.
- One directory per step, ``<directory>/<step>/``: one ``.npy`` file per
  array (numpy format, loaded with ``allow_pickle=False``; the file name is
  the path with ``.`` for ``/``), written by a few threads at once, and an
  ``index.json`` naming every array, written last.  The directory is
  written under a temporary name and renamed when complete (the
  ``durable`` discipline: file fsync, rename, directory fsync), so a torn
  write is never listed as a step.
- ``save(step, state, wait=False)`` writes on a background thread (one save
  in flight at a time; its error re-raises at the next ``wait``);
  ``publish`` waits out any write still in flight before it writes the
  manifest.  Steps beyond ``keep_max`` are pruned oldest first.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common import durable, trace
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("checkpoint")

#: The published-checkpoint manifest: a tiny JSON file next to the step
#: dirs naming the newest step whose save is COMPLETE.  The serving tier's
#: checkpoint watcher keys off this file — never off directory listings.
MANIFEST_NAME = "checkpoint_manifest.json"  # durable-file

#: The index of one step's arrays, inside its directory: written last.
INDEX_NAME = "index.json"

#: Threads writing one step's array files at once.
WRITE_THREADS = 4

_TMP_PREFIX = ".tmp-"


def publish_manifest(
    directory: str,
    step: int,
    code_rev: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomically publish ``step`` as the newest complete checkpoint.

    The durable.atomic_publish commit: a reader (the serving watcher,
    possibly in another process) sees either the previous manifest or the
    new one, never a half-written file.  The caller must only publish
    AFTER the checkpoint itself is fully committed: the manifest is the
    happens-after edge serving relies on.
    """
    path = os.path.join(directory, MANIFEST_NAME)
    payload = {
        "step": int(step),
        "code_rev": code_rev,
        "published_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if extra:
        payload.update(extra)
    durable.atomic_publish_json(path, payload)
    # The publish is the training->serving hand-off edge: its instant in
    # the merged trace is what publish-to-live latency is measured between
    # (pairs with the watcher's serving:hot_reload instant).
    trace.instant("ckpt:publish", cat="elastic", step=int(step))
    return path


# recovery-path
def read_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """The published manifest, or None when absent/unreadable.  Tolerant by
    design (durable.read_json_tolerant): a missing or garbage manifest
    means "nothing published yet", not an error."""
    path = os.path.join(directory, MANIFEST_NAME)
    m = durable.read_json_tolerant(path)
    if not isinstance(m, dict) or not isinstance(m.get("step"), int):
        return None
    return m


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_name(path: str) -> str:
    # Canonical paths carry no "." (module names' dots became "/").
    return path.replace("/", ".") + ".npy"


def state_nbytes(state: Dict[str, Any]) -> int:
    """Bytes of a canonical state's arrays (what one save writes)."""
    return int(sum(np.asarray(v).nbytes for v in state.values()))


class CheckpointManager:
    """Numbered step directories of canonical states under ``directory``."""

    def __init__(self, directory: str, keep_max: int = 3):
        if keep_max < 1:
            raise ValueError(f"keep_max must be >= 1, got {keep_max}")
        self.directory = os.path.abspath(directory)
        self.keep_max = keep_max
        os.makedirs(self.directory, exist_ok=True)
        # The one save in flight and the error it left; the thread handle
        # and the error are handed between the caller and the writer
        # thread under this leaf lock (nothing blocking runs under it).
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._error: Optional[BaseException] = None  # guarded-by: _lock

    # ---- writing ----

    def save(self, step: int, state: Dict[str, Any], wait: bool = False) -> None:
        """Write ``state`` (``{path: array}``) as checkpoint ``step``; on a
        background thread unless ``wait``.  A save waits out the previous
        one first, so writes never interleave."""
        self.wait()
        arrays = {k: np.asarray(v) for k, v in state.items()}
        if wait:
            self._write(int(step), arrays)
            return
        t = threading.Thread(
            target=self._write_bg, args=(int(step), arrays),
            name="edl-ckpt-write", daemon=True,
        )
        with self._lock:
            self._thread = t
        t.start()

    def _write_bg(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        try:
            self._write(step, arrays)
        except BaseException as e:  # re-raised at the caller's next wait()
            with self._lock:
                self._error = e

    def _write(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(
            self.directory, f"{_TMP_PREFIX}{step}-{os.getpid()}-{threading.get_ident()}"
        )
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        def write_one(path: str) -> None:
            with open(os.path.join(tmp, _file_name(path)), "wb") as f:
                np.save(f, arrays[path], allow_pickle=False)
                f.flush()
                os.fsync(f.fileno())

        try:
            # Largest first, so the threads finish together.
            order = sorted(arrays, key=lambda k: -arrays[k].nbytes)
            with ThreadPoolExecutor(WRITE_THREADS, thread_name_prefix="edl-ckpt-file") as pool:
                list(pool.map(write_one, order))
            index = {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in arrays.items()}
            with open(os.path.join(tmp, INDEX_NAME), "w") as f:
                json.dump({"step": step, "arrays": index}, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if os.path.exists(final):
            # Re-saving a step: the new copy replaces the old one whole.
            shutil.rmtree(final)
        durable.atomic_replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        for step in self.all_steps()[self.keep_max:]:
            shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)

    def wait(self) -> None:
        """Wait out the save in flight; re-raise the error it left."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()  # outside the lock: the join blocks
        with self._lock:
            if self._thread is t:
                self._thread = None
            err, self._error = self._error, None
        if err is not None:
            raise err

    def publish(
        self,
        step: int,
        code_rev: str = "",
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Publish ``step`` for online consumers (the serving watcher) —
        AFTER draining any in-flight save, so the manifest can never name a
        step that is not fully on disk."""
        self.wait()
        if step not in self.all_steps():
            raise FileNotFoundError(f"checkpoint step {step} is not under {self.directory}")
        return publish_manifest(self.directory, step, code_rev=code_rev, extra=extra)

    # ---- reading ----

    def all_steps(self) -> List[int]:
        """Complete checkpoint steps, newest first (temporary directories of
        a write in flight or torn by a crash are never listed)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                os.path.join(self.directory, name, INDEX_NAME)
            ):
                steps.append(int(name))
        return sorted(steps, reverse=True)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[0] if steps else None

    def restore(
        self, step: Optional[int] = None, prefixes: Optional[Tuple[str, ...]] = None
    ) -> Dict[str, np.ndarray]:
        """The canonical state of ``step`` (default: the newest) as numpy
        arrays; with ``prefixes``, only the arrays whose paths start with
        one of them (a serving replica reads ``("params/", "step")`` and
        skips the optimizer's moments).  Raises FileNotFoundError when
        there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        root = os.path.join(self.directory, str(step))
        with open(os.path.join(root, INDEX_NAME)) as f:
            index = json.load(f)["arrays"]
        out = {}
        for path in index:
            if prefixes is None or path.startswith(prefixes):
                out[path] = np.load(os.path.join(root, _file_name(path)), allow_pickle=False)
        return out

    def close(self) -> None:
        self.wait()
