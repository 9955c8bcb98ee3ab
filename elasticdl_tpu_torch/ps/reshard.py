"""Reshard PS host-store snapshots between fleet sizes, offline.

Port of ``elasticdl_tpu/ps/reshard.py``.  A PS fleet's size is fixed for
the life of a job (the ``id mod n`` partition of ``ps/service.py``), and a
shard's snapshot file loads only into a fleet of the same size.  This
module rewrites one snapshot step for a new fleet size, keeping every
row's values and optimizer slots bit for bit.

It parses the native store's file format directly (``csrc/edl_native.cc``
``edl_store_save``): a header ``n:i64, dim:i64, stride:i64, opt:i32``, then
``n`` records of ``id:i64, adam_t:i32, stride*f32``; the stride covers the
row and its optimizer slots, so resharding moves adagrad and adam state
with the weights.  The format is the reference's, so either package's
snapshots reshard here.

CLI:
    python -m elasticdl_tpu_torch.ps.reshard --directory CKPT_DIR --step S \
        --new-shards M
rewrites every table found at ``CKPT_DIR/host_stores/S`` in place (the new
shard files appear beside the old ones; ``--prune-old`` deletes the old
sharding's files after a successful rewrite).
"""

from __future__ import annotations

import argparse
import os
import re
import struct
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from elasticdl_tpu_torch.common import durable
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.ps.service import shard_of, snapshot_filename

logger = get_logger("ps.reshard")

_HEADER = struct.Struct("<qqqi")  # n, dim, stride, opt
_REC_HEAD = struct.Struct("<qi")  # id, adam_t

_FILE_RE = re.compile(r"^(?P<key>.+)\.shard(?P<i>\d+)of(?P<n>\d+)\.bin$")


def _record_dtype(stride: int) -> np.dtype:
    """The native writer's uniform record layout as a numpy structured dtype:
    one pass at memory speed instead of a Python loop over the rows (the
    host tier holds tables beyond the card's memory)."""
    return np.dtype(
        [("id", "<i8"), ("t", "<i4"), ("row", "<f4", (stride,))]
    )


def read_snapshot(path: str) -> Tuple[dict, np.ndarray, np.ndarray, np.ndarray]:
    """Parse one shard file -> (header, ids [n], adam_t [n], rows [n, stride])."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size:
        raise ValueError(f"{path}: truncated header")
    n, dim, stride, opt = _HEADER.unpack_from(raw)
    dtype = _record_dtype(stride)
    if len(raw) != _HEADER.size + n * dtype.itemsize:
        raise ValueError(
            f"{path}: expected {n} records of {dtype.itemsize} bytes, "
            f"got {len(raw) - _HEADER.size} payload bytes"
        )
    recs = np.frombuffer(raw, dtype, count=n, offset=_HEADER.size)
    return (
        {"dim": dim, "stride": stride, "opt": opt},
        recs["id"].copy(),
        recs["t"].copy(),
        recs["row"].copy(),
    )


def write_snapshot(path: str, header: dict, ids, adam_t, rows) -> None:
    """Write records in the native format, atomically
    (durable.atomic_publish: a resharded snapshot must commit whole)."""
    stride = header["stride"]
    recs = np.empty((len(ids),), _record_dtype(stride))
    recs["id"] = np.asarray(ids, np.int64)
    recs["t"] = np.asarray(adam_t, np.int32)
    recs["row"] = np.asarray(rows, np.float32).reshape(len(ids), stride)
    payload = _HEADER.pack(
        len(ids), header["dim"], stride, header["opt"]
    ) + recs.tobytes()
    durable.atomic_publish(path, payload)


def _tables_in(step_dir: str) -> Dict[str, Tuple[int, Dict[int, str]]]:
    """{table_key: (fleet_size, {shard_index: path})} for one step dir.

    Grouped by (key, fleet size) internally and REFUSING mixed shardings of
    the same table: without ``--prune-old`` a previous reshard leaves both
    sizes' files side by side, and silently mixing them (index collisions
    resolved by listdir order) would drop rows without an error.
    """
    by_size: Dict[Tuple[str, int], Dict[int, str]] = defaultdict(dict)
    for name in os.listdir(step_dir):
        m = _FILE_RE.match(name)
        if m:
            by_size[(m.group("key"), int(m.group("n")))][int(m.group("i"))] = (
                os.path.join(step_dir, name)
            )
    sizes_per_key: Dict[str, List[int]] = defaultdict(list)
    for key, n in by_size:
        sizes_per_key[key].append(n)
    for key, sizes in sizes_per_key.items():
        if len(sizes) > 1:
            raise ValueError(
                f"table {key!r} has snapshots for MULTIPLE fleet sizes "
                f"{sorted(sizes)} in {step_dir}; delete the stale sharding "
                "(or rerun the previous reshard with --prune-old) first"
            )
    return {key: (n, shards) for (key, n), shards in by_size.items()}


def reshard_step(
    directory: str, step: int, new_shards: int, prune_old: bool = False
) -> Dict[str, int]:
    """Rewrite every table at ``directory/host_stores/step`` for a
    ``new_shards``-sized fleet.  Returns {table_key: row_count}.  Refuses
    torn inputs (a missing old shard would silently drop its rows) and
    mixed shardings (see _tables_in)."""
    if new_shards <= 0:
        raise ValueError("new_shards must be positive")
    step_dir = os.path.join(directory, "host_stores", str(step))
    tables = _tables_in(step_dir)
    if not tables:
        raise FileNotFoundError(f"no shard files under {step_dir}")
    out: Dict[str, int] = {}
    for key, (old_n, shards) in tables.items():
        missing = [i for i in range(old_n) if i not in shards]
        if missing:
            raise FileNotFoundError(
                f"table {key!r} step {step}: shard {missing[0]} of {old_n} "
                "missing — torn snapshot, refusing to reshard"
            )
        header = None
        all_ids: List[np.ndarray] = []
        all_t: List[np.ndarray] = []
        all_rows: List[np.ndarray] = []
        for i in range(old_n):
            h, ids, adam_t, rows = read_snapshot(shards[i])
            if header is None:
                header = h
            elif h != header:
                raise ValueError(
                    f"table {key!r}: shard {i} header {h} != shard 0 {header}"
                )
            # Sanity: every id really belongs to the shard that held it.
            owners = shard_of(ids, old_n)
            if ids.size and not (owners == i).all():
                bad = ids[owners != i][0]
                raise ValueError(
                    f"table {key!r}: id {bad} found in shard {i} of {old_n} "
                    f"but belongs to shard {int(shard_of(np.array([bad]), old_n)[0])}"
                )
            all_ids.append(ids)
            all_t.append(adam_t)
            all_rows.append(rows)
        ids = np.concatenate(all_ids) if all_ids else np.empty((0,), np.int64)
        adam_t = np.concatenate(all_t)
        rows = np.concatenate(all_rows)
        owners = shard_of(ids, new_shards)
        for j in range(new_shards):
            sel = owners == j
            write_snapshot(
                os.path.join(
                    step_dir, snapshot_filename(key, j, new_shards)
                ),
                header, ids[sel], adam_t[sel], rows[sel],
            )
        if prune_old and old_n != new_shards:
            for i in range(old_n):
                os.remove(shards[i])
        out[key] = int(ids.size)
        logger.info(
            "resharded %s step %d: %d rows, %d -> %d shards",
            key, step, ids.size, old_n, new_shards,
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elasticdl_tpu_torch.ps.reshard")
    ap.add_argument("--directory", required=True, help="job checkpoint dir")
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--new-shards", type=int, required=True)
    ap.add_argument("--prune-old", action="store_true")
    args = ap.parse_args(argv)
    counts = reshard_step(
        args.directory, args.step, args.new_shards, prune_old=args.prune_old
    )
    print({"resharded": counts, "new_shards": args.new_shards})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
