"""On-card smoke run of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``.  It drives the port (``elasticdl_tpu_torch``) and
never the JAX package, in phases; any failed phase raises and the script
exits non-zero without its result line:

1. build every kernel source from ``elasticdl_tpu_torch/csrc`` at once (one
   nvcc each, into ``elasticdl_tpu_torch/csrc/build/``, at first use) and
   report each bf16 kernel's registers, shared memory, spills and blocks
   per SM (forward, dq, dkv; D=64 and D=128).  The build starts first and
   runs in threads beside phases 10 and 14, which run before every other
   phase because they launch no hand-written kernel; the script then waits
   for what is left of it;
2. hold the flash forward against its plain PyTorch version on the card at
   the serving and training paths' shapes and layout (q, k, v as views into
   the fused qkv projection) and others (D=128; D=36, which the wrapper
   pads to 40; L=8192), check that the limits reject two wrong versions (a
   key tile skipped; the causal mask dropped on the diagonal tile), and
   time kernel, plain version and the library yardstick
   (``F.scaled_dot_product_attention``, timed here only: the port never
   calls it) at both paths' shapes;
3. the same for the backward kernels (dq, dkv) at the training shape and
   others (D=128; D=36, which the wrapper pads to 40; L=8192), with two
   wrong versions each limit must reject, and the backward of
   ``F.scaled_dot_product_attention`` as the yardstick;
4. train ``transformer_lm`` at the GPT-2-small width (vocab 32768, dim
   768, 12 heads, 12 layers, 1024 tokens, batch 16) for 10 steps through
   ``Trainer.run_train_steps`` with the launch counts zeroed just before
   and read just after; one step with remat; one step's loss and
   gradients against the plain attention;
5. serve the same width in process through the micro-batcher, with the
   launch counts zeroed just before and read just after;
6. start a replica through ``serving/main.py`` in a subprocess (zoo-default
   width, 128 tokens) and answer gRPC Predict and ModelInfo with the wire
   sanitizer armed.
7. run the elastic job at phase 4's width: RecordIO shards of
   ``synthetic_lm`` records, a ``MasterServer`` on localhost gRPC, one
   ``Worker`` over ``RpcMasterProxy`` (8 training tasks, 32 steps, eval
   rounds with a masked tail, background checkpoints every 16 steps), a
   ``ServingServer`` hot-reloading each published step, with the launch
   counts zeroed just before and read just after; the last save must equal
   the live state exactly; then a second job over the same checkpoint
   directory resumes at step 32 with bit-exact arrays, and its state's next
   train step matches the live state's;
8. run the process-level job at the same width on the same files through
   the CLI's local mode (``python -m elasticdl_tpu_torch.client.main
   train`` in a subprocess: a ``Master`` with a ``ProcessPodBackend`` and
   one worker process on the card) with a ``ServingServer`` in this
   process polling the manifest: the first worker is SIGKILLed once the
   manifest names the first checkpoint and its relaunch joins from that
   step; the relaunch is SIGTERMed during a later task, snapshots, exits 3
   and is relaunched without charging the budget, and the last
   incarnation joins from the snapshot and finishes.  Every task done,
   none abandoned, the relaunch counts, the replica's applied steps, and
   the last worker process's launch counts (12 a forward, 12/12/12 a
   train step; its ``[worker-event]`` summary line) are checked; the
   recovery is timed from each signal to the next first step;
9. phase 8's SIGKILL again, with a warm standby (``--warm_worker_standby``):
   the pod manager adopts a parked spare that paid its imports under the
   relaunch's name; the job finishes, the adopted process's launch counts
   are checked, and the recovery is timed against phase 8's cold one;
10. DeepFM on Criteo at the JAX bench's width (65536 buckets a feature,
   dim 8, MLP 400-400, batch 8192, bf16 over f32, the native preprocessing
   feed, Adam): the card's logits and gradients against the same weights
   on the CPU in f32, out-of-range ids (NaN rows, no device assert), the
   native decode against the plain one on 8192 records; the device step
   by bench.py's protocol (5 warm-up, 30 measured steps) with a profile
   split into gather, scatter-add, Adam, GEMMs and the rest; the gather
   and the scatter-add against their byte bounds; the end-to-end job of
   ``tools/bench_e2e.py`` (RecordIO, ``MasterServicer``, one ``Worker``
   with prep-ahead; 18 tasks of 65536 records, 2 excluded) with the ingest
   pool on auto and at one thread; one eval round on a file with a masked
   tail after a two-epoch job, whose AUC must exceed 0.5 on the planted
   rule;
11. gang mode: (a) a ``Trainer`` over a one-rank NCCL process group at
   phase 4's width and batch (remat on) against the bare ``Trainer`` from
   the same seeded state (twice, to show the step repeats): the states must
   be equal bit for bit; its step p50, the bare one's and the NCCL kernels'
   device time.  Then its fused dispatch: ``train_scan`` of T=4 steps, a
   warm (eager) task, then the capture with the all-reduces inside the
   graph; a replay under ``torch.cuda.set_sync_debug_mode("error")``
   against the per-step loop over the same group from the same state (the
   losses, every parameter and optimizer slot bit for bit, the flash
   launches 24/12/12 a step on both); the collective calls the capture
   recorded, which a replay adds, equal to an eager task's; the NCCL
   kernels of one profiled replay against one eager task's (none in either:
   NCCL returns at once from a one-rank in-place all-reduce); the
   contributor mask set to all-zero between the capture and a replay (the
   replay equals the eager loop under that mask and differs from the
   all-ones replay); ``eval_scan`` likewise; the step ms both ways, the
   capture seconds and the graph pool bytes.  In the same world, DeepFM at
   phase 10's width (batch 8192, Adam, nothing cut) with its table
   row-sharded over the group (ParameterServer) and an explicit ``ragged``
   lookup, whose equal-split all-to-alls run over the one-rank group:
   phase 17's checks on a task of T=8 (bit for bit under sync-debug
   "error"), a replay adding the eager task's calls (24 ``lookup:
   all_to_all``, no ``lookup:all_gather``), the NCCL kernels and device
   copies of one replay, one eager task and one lookup forward alone
   (reported, not held), the step ms both ways in turns, the capture
   seconds and pool bytes.  (b) two NCCL ranks on the
   one card (the installed NCCL refuses them; its error is logged), then
   two worker processes on the card through the CLI's local mode
   (``--multihost --dcn_data_parallelism=2``, the gloo backend on card
   tensors, 8 of each 16 examples a rank, each task one ``train_scan`` run
   eagerly: gloo's calls cannot be captured) over
   phase 7's files with eval rounds: rank 1 is SIGKILLed at a task boundary
   past step 20, rank 0's collective fails, it snapshots and exits 3, the
   pod manager relaunches both, the gang re-forms from the snapshot and
   finishes.  Equal state digests on both ranks at every checkpoint, the
   first 4 steps' losses against one process on the same batches of 16,
   every task done once and the epoch's step count at the end (no step
   trained twice), the exit codes, the launch counts; the gang step p50, the
   all-reduce's share and the re-form time split into its stages.
12. the ParameterServer strategy across ranks and the sharded optimizer,
   two ranks on the card over gloo (``phase_ps``, ``phase_opt_shard``):
   (a) DeepFM at phase 10's width under ``--distribution_strategy=
   ParameterServer`` on the flat ``{dp: 2}`` mesh, half the table's rows a
   rank: a spawned world probes every new collective on card tensors, then
   holds the first 4 losses of each lookup route against one process's
   replicated ``Trainer`` on the same batches of 8192 (the limit must
   reject a dropped table gradient and one summed again over the table
   axis); one CLI job per route (``--multihost --num_workers=2
   --dcn_data_parallelism=1``), rank 1 SIGKILLed past step 20 in the ragged
   one: no survivor's snapshot, both relaunches resume from the periodic
   checkpoint, the final step is that checkpoint's plus the steps of the
   tasks the master had not counted; per rank the table and optimizer
   bytes, the lookup's collective ms a step by op (in the loss world too),
   step p50; the last
   checkpoint restored into a world of one equals the gathered live state
   bit for bit and takes a step.  (b) ``transformer_lm`` at phase 4's width
   under ``--optimizer_sharding=sharded`` over two spawned ranks, batch 8 a
   rank, 4 steps: losses against one process at batch 16, optimizer bytes
   a rank about half the replicated ones, the gathered state restored into
   a world of one bit for bit, the step split into reduce-scatter,
   all-gather and the rest.
13. the PS host tier (``phase_host_tier``): DeepFM at 2^20 buckets a
   feature, whose "auto" resolution puts the FM table in the native host
   store (27,262,976 rows), dim 8, MLP 400-400, batch 8192. (a) In
   process: the card against the CPU at f32 over 3 steps, each side with
   a fresh store (losses and step 1's gradients within ``DFM_F32_REL``,
   the touched rows by ``HOST_ROW_FLIPS``); on one store, 5 warm steps and
   3 pairs of 10 timed steps sync and ``use_async`` (depth 1), the order
   alternating: each pair's step p50s and ratio, examples/s, the sync
   step's parts (pull, H2D,
   device, the wait for the gradients' copy, push; the copy alone), the
   store's rows and the resident memory. (b) The CLI job with
   ``--num_ps_pods=2 --use_async`` on a synthetic Criteo RecordIO file
   (4 tasks of 4 minibatches, a checkpoint every 8 steps, an eval round):
   PS shard 1 SIGKILLed after the first checkpoint, relaunched, restoring
   its slice; the job ends at step 16; the job's step p50, the relaunch
   time, the AUC. (c) A replica on the card over (b)'s checkpoint with
   ``ps_addresses`` (a fleet restored from it) behind the hot-id cache: 64
   requests with skewed ids, the cache's hit rate after warm-up, request
   and flush p50; after pushes under it, a publish empties the cache and
   the answers equal a fresh pull's. No flash kernel runs here.
14. the model zoo (``phase_zoo``) at the reference bench's widths: MNIST,
   ResNet-50 on CIFAR-10 (stages 3-4-6-3, width 64, GroupNorm(8)) and
   Wide&Deep on census (65536 buckets, dim 8, MLP 100-50; its two tables
   row-sharded under ParameterServer, a world of one). (a) Each model 3
   steps in f32 on the card and on the CPU from the same weights: every
   loss, step 1's gradients and all parameters after the steps within
   ``ZOO_F32_REL``. (b) Each at its bench batch (4096, 512, 8192) in bf16:
   5 warm-up and 30 timed steps, step p50 by CUDA events, examples/s,
   peak memory, the step's FLOPs against the bf16 peak, the loss falling;
   ResNet-50's step split by torch.profiler into convolutions and GEMMs,
   GroupNorm and elementwise work, SGD and the rest, with the host's
   enqueue. (c) The Wide&Deep CLI job with ``--prep_depth=2`` on a SQLite
   census table (16 tasks of 8192 rows): the prep pool's width 1, an eval
   round's AUC, a checkpoint. (d) A replica over that checkpoint answers
   16 requests, equal to ``predict`` in process. No flash kernel runs
   here.
15. ``transformer_lm`` across ranks (``phase_ring_tp``), gloo ranks on
   card tensors at phase 4's width. (a) The ring over 2 and 4 spawned ranks
   at the training attention shape (B=16, global L=1024, H=12, D=64), bf16
   and f32, causal: output and gradients against the plain attention over
   the whole sequence in f32 on one process; each limit must reject a ring
   that skips the first rotated block and one that masks with local
   positions; gloo's bf16 sum of card tensors checked exact. (b) The
   sequence path on ``{dp: 2}`` (the ring), global batch 8, 4 steps: losses
   against one process on the same batches from the same weights (the
   limit must reject a ring that never rotates), one state on both ranks,
   step p50 and the ring's p2p ms a step. (c) The tensor path on ``(dp 1,
   tp 2)`` and ``(dp 2, tp 2)``: the same, the limit rejecting a version
   without *f*; half the matmul weights a rank; the tp all-reduce's ms a
   step; the gathered state restored into a world of one bit for bit, and
   a step. (d) One CLI job, ``--multihost --num_workers=2
   --tensor_parallelism=2``, over 256 of phase 7's training sequences (16
   steps) and its validation file, with eval rounds and checkpoints: every
   task done once, the epoch's step count, equal digests. Neither path
   launches a flash kernel across ranks, as in the reference.
16. the serving fleet (``phase_fleet``): ``transformer_lm`` at the
   GPT-2-small layer width (128 tokens, vocab 8192) in replica processes
   (``python -m elasticdl_tpu_torch.serving.main``) under a
   ``ServingFleetController`` over ``ProcessPodBackend`` with one warm
   standby, over a published checkpoint, behind the p2c
   ``FleetServingClient``, the control loop driven by ``poll_once``.
   (a) ``start(2)``: each replica's cold boot-to-ready. (b) The same
   tokens until every replica answered, at buckets 1 and 2: equal bit for
   bit, and within ``MODEL_MAX_ABS``/``MODEL_MEAN_ABS`` of one process's
   forward with the plain attention. (c) Online traffic at a fixed rate
   breaks a 1 ms p99 target: two pressured polls scale 2 -> 3 and adopt
   the warm spare; idle polls under bulk-lane traffic retire back to 2
   (``drain_s`` 1.5); the events exactly ``[(2, 3), (3, 2)]``; Predict
   p50 and p99 at 2 and 3 replicas. (d) A replica SIGKILLed under
   traffic, relaunched as ``-r1``: zero failed requests, SIGKILL to ready.
   (e) A second controller over the same registry, the first not stopped,
   adopts the live replicas: same addresses, nothing spawned, equal
   answers. (f) Per replica, flash forward launches = 12 x (flushes + warm
   forwards), flushes in buckets 1 and 2, requests answered.
17. the fused task dispatch (``phase_fused``): ``train_scan`` and
   ``eval_scan`` as captured CUDA graphs, one replay a task, for
   ``transformer_lm`` at phase 4's width (B=16, remat on: all three flash
   kernels inside the graph), ResNet-50 (B=512) and MNIST (B=4096) as in
   phase 14, DeepFM as in phase 10 (B=8192, no host tier) and Wide&Deep
   (B=8192) as in phase 14.  For each, one stacked batch of 8 steps (the
   batch's rows permuted a step): a warm-up task (eager, the variant's
   first) and the capture; then a replay under
   ``torch.cuda.set_sync_debug_mode("error")`` against the per-step loop
   from the same state (the losses, every parameter and optimizer slot:
   bit for bit, or within ``FUSED_REL`` where the table gradients sum with
   atomics; the launch counts equal); a restore, then a fused task (the
   graph dropped and captured anew, training the restored state); the same
   for ``eval_scan``.  These comparisons run ResNet-50 and MNIST with
   cuDNN's deterministic algorithms; the rest runs cuDNN's default, the
   worker's path, on a trainer of its own that restores the trained state
   (its first task eager, its second captured): 2 tasks of each path in
   turns (step ms, host enqueue ms) and one of each under torch.profiler
   (device-busy ms and kernels a step); capture seconds and the graph
   pool's bytes; a fifth batch variant raises ``ScanBudgetError``.

Every training and eval task of the jobs of phases 7-12, 14 and 15 runs
fused by default (one ``train_scan`` a task plus a step for a ragged
tail): captured alone on the card and over NCCL (phase 11 (a), the ragged
lookup included), eagerly in the gloo gangs of phases 11 (b), 12 and
15 (d), the ragged lookup's job included.  Only the host
tier (phase 13) stays per step: its pulls and pushes run around every
step.

Prints the card's name and power limit first, a ``{"kernels": [...]}``
line before the last, and ``{"ok": true, "device": {...}}`` last.  The
numbers, each phase's wall seconds among them, also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the tensor-core rate of its type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# The serving path's attention shape at the GPT-2-small width.
B, L, H, D = 4, 1024, 12, 64
# The training path's attention shape (GPT-2-small width, batch 16).
BT, LT, HT, DT = 16, 1024, 12, 64
# Kernel against plain version, per dtype: O's error norm over O's norm
# ("o_rel"), O's largest element error over O's largest element ("o_max"),
# and lse's largest absolute error ("lse").  Set from the kernel's readings
# on the card (bf16 O within one output ulp, lse to f32 summation order) with
# room on both sides: every case also computes what a kernel that skipped
# one 64-key tile would give, and each limit must reject that reading; a
# causal case also what a kernel that left the diagonal tile unmasked would
# give, which the lse and o_max limits must reject.
TOL = {
    torch.bfloat16: {"o_rel": 1e-2, "o_max": 2**-5, "lse": 1e-4},
    torch.float32: {"o_rel": 1e-5, "o_max": 1e-4, "lse": 2e-5},
}
# Full-width served logits against the same model with the plain attention
# (both bf16 through 12 layers; one bf16 ulp of a logit of magnitude 4 is
# 0.016): max and mean absolute difference.
MODEL_MAX_ABS, MODEL_MEAN_ABS = 0.25, 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events.

    A spin kernel holds the stream while the host enqueues the timed
    calls, so the events time the device's work back to back and not the
    host's launch rate (a kernel of tens of microseconds takes about as
    long to enqueue)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Twice the host time of all the calls, at 2 GHz (the spin counts clocks).
    torch.cuda._sleep(int(2 * (time.perf_counter() - t) * iters * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(b, l, h, d, dtype, causal, kernel: str = "fwd") -> tuple:
    """(bound ms, what bounds it) for one attention kernel over the (query,
    key) pairs the inputs need (causal: the L(L+1)/2 on or below the
    diagonal), each input read once and each output written once:
    fwd reads q, k, v, writes o and the f32 lse, 4*D flops per pair; dq
    reads q, k, v, o, dO and lse, writes dq and the f32 delta, 6*D per
    pair; dkv reads q, k, v, dO, lse and delta, writes dk and dv, 8*D per
    pair."""
    tensor = b * l * h * d * torch.empty((), dtype=dtype).element_size()
    vector = b * h * l * 4
    nbytes, per_pair = {
        "fwd": (4 * tensor + vector, 4),
        "dq": (6 * tensor + 2 * vector, 6),
        "dkv": (6 * tensor + 2 * vector, 8),
    }[kernel]
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    return bound_ms(nbytes, per_pair * d * pairs, dtype)


def kernel_info() -> dict:
    """Registers, static and dynamic shared memory, spill bytes and resident
    blocks per SM of each bf16 kernel, forward and backward, at D=64 and
    D=128 (the CUDA runtime's function attributes and occupancy
    calculator)."""
    import ctypes

    from elasticdl_tpu_torch.ops import flash_attention, kernels

    fwd = kernels.bind(flash_attention.SOURCE, "flash_attention_fwd_kernel_info",
                       (ctypes.c_int, ctypes.c_void_p))
    bwd = kernels.bind(flash_attention.BWD_SOURCE, "flash_attention_bwd_kernel_info",
                       (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    queries = [("fwd", fwd)]
    queries += [(name, lambda d, out, i=i: bwd(i, d, out)) for i, name in enumerate(("dq", "dkv"))]
    report = {}
    for name, query in queries:
        for d in (64, 128):
            out = (ctypes.c_int * 5)()
            status = query(d, ctypes.addressof(out))
            assert status == 0, f"kernel_info({name}, D={d}): cudaError {status}"
            info = dict(zip(("registers", "static_smem", "dynamic_smem", "spill_bytes",
                             "blocks_per_sm"), list(out)))
            report[f"{name}_D{d}"] = info
            log(f"[build]   {name} bf16 D={d}: " + json.dumps(info))
    return report


def start_build():
    """Start building every kernel source at once (one nvcc per source, each
    in its own thread: the builds hold per-source locks); ``phase_build``
    waits for them.  Nothing but nvcc runs in those threads."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticdl_tpu_torch.ops import flash_attention, kernels

    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE)
    pool = ThreadPoolExecutor(len(sources))
    t0 = time.perf_counter()

    def build(source):
        kernels.load(source)
        return time.perf_counter() - t0

    return sources, [pool.submit(build, source) for source in sources], pool


def phase_build(pending=None) -> dict:
    """Wait for the build ``start_build`` started (or start it, for a
    script that runs single phases) and log each source's nvcc seconds,
    registers and spills, and the bf16 kernels' shared memory and blocks
    per SM."""
    from elasticdl_tpu_torch.ops import kernels

    sources, futures, pool = pending or start_build()
    t0 = time.perf_counter()
    wall = max(f.result() for f in futures)
    pool.shutdown()
    report = {"wall_s": wall, "wait_s": time.perf_counter() - t0, "sources": {}}
    for source in sources:
        seconds, build_log = kernels.build_info(source)
        log(f"[build] {source}: nvcc {seconds:.2f}s")
        for line in build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
        report["sources"][source] = {"nvcc_s": seconds}
    log(f"[build] {len(sources)} sources built concurrently in {wall:.2f}s, beside phases 10 "
        f"and 14; waited {report['wait_s']:.2f}s for them after those")
    report["kernels"] = kernel_info()
    return report


def _plain_wrong(q, k, v, causal, fault):
    """The plain version's arithmetic with one fault: "tile_skipped", the
    first 64-key tile masked for every query row past it (what a kernel
    that skipped that tile would give; each limit in TOL must reject it);
    or "diagonal_unmasked", the causal mask dropped on the diagonal 64x64
    tile, so the later keys inside it leak into each row (the lse and o_max
    limits must reject it)."""
    b, l, h, d = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d**-0.5
    keep = torch.ones(l, l, dtype=torch.bool, device=q.device)
    if fault == "tile_skipped":
        keep[64:, :64] = False
    if causal:
        tile = torch.arange(l, device=q.device) // 64
        diagonal = tile[:, None] == tile[None, :]
        unmasked = diagonal & (fault == "diagonal_unmasked")
        keep &= torch.ones_like(keep).tril() | unmasked
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=-1)
    o = torch.matmul(p.to(q.dtype).float(), vf) / den[..., None]
    return o.to(q.dtype).permute(0, 2, 1, 3), (m + torch.log(den)).reshape(b * h, l)


def _readings(out, lse, ref, ref_lse) -> dict:
    err = out.float() - ref.float()
    return {
        "o_rel": (err.norm() / ref.float().norm()).item(),
        "o_max": (err.abs().max() / ref.float().abs().max()).item(),
        "o_max_abs": err.abs().max().item(),
        "lse": (lse - ref_lse).abs().max().item(),
    }


def phase_kernel_check() -> dict:
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, (b, l, h, d), dtype, causal, input scale, q/k/v as views into
    # one fused [B, L, 3*H*D] projection as the model passes them).  Scale
    # 0.5 gives near-uniform attention, scale 2 a peaked softmax.
    cases = [
        ("serve", (B, L, H, D), bf16, True, 0.5, True),
        ("bf16_causal", (B, L, H, D), bf16, True, 0.5, False),
        ("bf16_full", (B, L, H, D), bf16, False, 0.5, False),
        ("bf16_causal_peaked", (B, L, H, D), bf16, True, 2.0, True),
        ("f32_causal", (B, L, H, D), f32, True, 0.5, False),
        ("f32_full", (B, L, H, D), f32, False, 0.5, False),
        ("bf16_causal_L128", (2, 128, 3, 64), bf16, True, 0.5, False),
        ("train", (BT, LT, HT, DT), bf16, True, 0.5, True),
        ("bf16_causal_D128", (2, 256, 2, 128), bf16, True, 0.5, True),
        ("f32_full_D128", (2, 256, 2, 128), f32, False, 0.5, False),
        # The serving shape's bytes at D=128 (timed: the D=128 tile choice).
        ("bf16_causal_D128_wide", (B, L, H // 2, 2 * D), bf16, True, 0.5, True),
        # D=36: the wrapper's route through a head dim padded to 40.
        ("bf16_causal_D36", (2, 256, 2, 36), bf16, True, 0.5, True),
        ("bf16_causal_L8192", (1, 8192, 2, 64), bf16, True, 0.5, True),
    ]
    for name, (b, l, h, d), dtype, causal, scale, fused in cases:
        if fused:
            qkv = (torch.randn((b, l, 3 * h * d), generator=gen, device="cuda") * scale).to(dtype)
            q, k, v = qkv.view(b, l, 3 * h, d).split(h, dim=2)
        else:
            q, k, v = (
                (torch.randn((b, l, h, d), generator=gen, device="cuda") * scale).to(dtype)
                for _ in range(3)
            )
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal)
        tol = TOL[dtype]
        got = _readings(out, lse, ref, ref_lse)
        wrong = {"tile_skipped": _readings(*_plain_wrong(q, k, v, causal, "tile_skipped"),
                                           ref, ref_lse)}
        if causal:
            wrong["diagonal_unmasked"] = _readings(
                *_plain_wrong(q, k, v, causal, "diagonal_unmasked"), ref, ref_lse)
        row = {"shape": [b, l, h, d], "dtype": str(dtype).split(".")[-1], "causal": causal,
               "input_scale": scale, "fused_qkv_views": fused, "tol": tol,
               "kernel": got, "wrong": wrong}
        log(f"[kernel] flash_attention_fwd {name}: kernel {json.dumps(got)}; limits "
            f"{json.dumps(tol)}; wrong versions {json.dumps(wrong)}")
        for key, limit in tol.items():
            assert got[key] <= limit, f"{name}: kernel {key} {got[key]:.3g} over {limit:.3g}"
            assert wrong["tile_skipped"][key] > limit, (
                f"{name}: limit {key} {limit:.3g} does not reject a skipped tile "
                f"({wrong['tile_skipped'][key]:.3g})")
        if causal:
            for key in ("lse", "o_max"):
                assert wrong["diagonal_unmasked"][key] > tol[key], (
                    f"{name}: limit {key} {tol[key]:.3g} does not reject an unmasked diagonal "
                    f"tile ({wrong['diagonal_unmasked'][key]:.3g})")
            row["diagonal_unmasked_rejected_by"] = [
                key for key, limit in tol.items() if wrong["diagonal_unmasked"][key] > limit]
        if (b, l) in ((B, L), (BT, LT)) and scale == 0.5:
            row["ms"] = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
            row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            )
            row["bound_ms"], row["bound_by"] = attention_bound_ms(b, l, h, d, dtype, causal)
            log(f"[kernel] flash_attention_fwd {name}: ms {row['ms']:.4f}, plain "
                f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']})")
        results[name] = row
    return results


# Backward kernels against the plain version, per dtype: for each of dq,
# dk, dv the error norm over the reference's norm ("rel") and the largest
# error over the largest element ("max"); delta's largest error over its
# largest element ("delta").  Set from the kernels' readings on the card
# (NVIDIA H100 80GB HBM3, 700 W; bf16: rel up to 3.5e-4 at L=8192, max up
# to 5.1e-3, about one output ulp; PERF.md's backward limits table) with
# room on both sides: every case also computes two wrong versions (the
# backward with delta dropped, and with the diagonal 64x64 tile of every
# block skipped).  Every limit must reject the skipped tile, and the norm
# limits of dq and dk the dropped delta too (delta does not enter dv, and
# moves the largest element of dk by only 2.8e-2 under full attention).
BWD_TOL = {
    torch.bfloat16: {"rel": 2e-3, "max": 2**-5, "delta": 1e-5},
    torch.float32: {"rel": 1e-5, "max": 1e-4, "delta": 1e-5},
}


def _bwd_plain_wrong(q, k, v, o, lse, do, causal, drop_delta=False, skip_diagonal_tiles=False):
    """The plain backward's arithmetic with one fault: delta taken as 0, or
    every (query tile, key tile) pair on the 64x64 block diagonal skipped
    (what an off-by-one at the causal loop's end (dq) or start (dkv) would
    give).  Readings each limit in BWD_TOL must reject."""
    b, l, h, d = q.shape
    qf, kf, vf, of, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d**-0.5
    keep = torch.ones(l, l, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    if skip_diagonal_tiles:
        tile = torch.arange(l, device=q.device) // 64
        keep &= tile[:, None] != tile[None, :]
    p = torch.exp(s.masked_fill(~keep, float("-inf")) - lse.reshape(b, h, l, 1))
    delta = torch.zeros_like(lse).reshape(b, h, l) if drop_delta else (gf * of).sum(-1)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds.to(q.dtype).float(), kf) * d**-0.5
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf) * d**-0.5
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gf)
    return tuple(x.to(q.dtype).permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _grad_readings(got, ref) -> dict:
    out = {}
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = x.float() - r.float()
        out[name] = {"rel": (err.norm() / r.float().norm()).item(),
                     "max": (err.abs().max() / r.float().abs().max()).item(),
                     "max_abs": err.abs().max().item()}
    return out


def phase_kernel_check_bwd() -> dict:
    """Each backward kernel against its plain version on the card, its
    limits against two wrong versions, and (at the training shape) the
    times of kernel, plain version, bound and library yardstick (the
    backward of ``F.scaled_dot_product_attention``, timed only)."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    train = (BT, LT, HT, DT)
    # (name, (b, l, h, d), dtype, causal, input scale, q/k/v as views into
    # one fused qkv and the gradients written into one fused dqkv).
    cases = [
        ("train", train, bf16, True, 0.5, True),
        ("bf16_full", train, bf16, False, 0.5, True),
        ("bf16_causal_peaked", train, bf16, True, 2.0, True),
        ("f32_causal", train, f32, True, 0.5, False),
        ("bf16_causal_L128", (2, 128, 3, 64), bf16, True, 0.5, False),
        ("bf16_causal_D128", (2, 256, 2, 128), bf16, True, 0.5, True),
        ("f32_full_D128", (2, 256, 2, 128), f32, False, 0.5, False),
        # D=36: the wrapper's route through a head dim padded to 40.
        ("bf16_causal_D36", (2, 256, 2, 36), bf16, True, 0.5, True),
        ("bf16_causal_L8192", (1, 8192, 2, 64), bf16, True, 0.5, True),
    ]
    results = {}
    for name, (b, l, h, d), dtype, causal, scale, fused in cases:
        if fused:
            qkv = (torch.randn((b, l, 3 * h * d), generator=gen, device="cuda") * scale).to(dtype)
            q, k, v = fa._split_qkv(qkv, h)
            dqkv = torch.empty_like(qkv)
            dq_buf, dk_buf, dv_buf = fa._split_qkv(dqkv, h)
        else:
            q, k, v = ((torch.randn((b, l, h, d), generator=gen, device="cuda") * scale).to(dtype)
                       for _ in range(3))
            dq_buf, dk_buf, dv_buf = (torch.empty_like(q) for _ in range(3))
        do = torch.randn((b, l, h, d), generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, dq=dq_buf)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, dk=dk_buf, dv=dv_buf)
        torch.cuda.synchronize()
        ref_dq, ref_delta = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        ref = (ref_dq, *fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, ref_delta, causal))
        got = _grad_readings((dq, dk, dv), ref)
        got["delta"] = ((delta - ref_delta).abs().max() / ref_delta.abs().max()).item()
        wrong = {
            "delta_dropped": _grad_readings(
                _bwd_plain_wrong(q, k, v, o, lse, do, causal, drop_delta=True), ref),
            "tile_skipped": _grad_readings(
                _bwd_plain_wrong(q, k, v, o, lse, do, causal, skip_diagonal_tiles=True), ref),
        }
        tol = BWD_TOL[dtype]
        row = {"shape": [b, l, h, d], "dtype": str(dtype).split(".")[-1], "causal": causal,
               "input_scale": scale, "fused_qkv": fused, "tol": tol, "kernel": got,
               "wrong": wrong}
        log(f"[kernel-bwd] {name}: kernel {json.dumps(got)}; limits {json.dumps(tol)}")
        log(f"[kernel-bwd] {name}: wrong versions {json.dumps(wrong)}")
        # Dropped, delta reads 1 against its own limit.
        assert got["delta"] <= tol["delta"], f"{name}: delta {got['delta']:.3g}"
        for g in ("dq", "dk", "dv"):
            for key in ("rel", "max"):
                assert got[g][key] <= tol[key], f"{name}: kernel {g} {key} {got[g][key]:.3g}"
                assert wrong["tile_skipped"][g][key] > tol[key], (
                    f"{name}: limit {g} {key} {tol[key]:.3g} does not reject a skipped tile")
            assert g == "dv" or wrong["delta_dropped"][g]["rel"] > tol["rel"], (
                f"{name}: limit {g} rel {tol['rel']:.3g} does not reject a dropped delta")
        if name == "train":
            row["dq_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, dq=dq_buf))
            row["dkv_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal, dk=dk_buf, dv=dv_buf))
            row["dq_plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal), iters=5)
            row["dkv_plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2).contiguous()
            row["library_ms"] = time_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True))
            row["dq_bound_ms"], row["dq_bound_by"] = attention_bound_ms(
                b, l, h, d, dtype, causal, "dq")
            row["dkv_bound_ms"], row["dkv_bound_by"] = attention_bound_ms(
                b, l, h, d, dtype, causal, "dkv")
            log(f"[kernel-bwd] train: dq {row['dq_ms']:.4f} ms (plain {row['dq_plain_ms']:.4f}, "
                f"bound {row['dq_bound_ms']:.4f} {row['dq_bound_by']}); dkv "
                f"{row['dkv_ms']:.4f} ms (plain {row['dkv_plain_ms']:.4f}, bound "
                f"{row['dkv_bound_ms']:.4f} {row['dkv_bound_by']}); SDPA backward "
                f"{row['library_ms']:.4f} ms")
        results[name] = row
    return results


def _count(name: str) -> int:
    from elasticdl_tpu_torch.ops import kernels

    return kernels.counts().get(name, 0)


# Profiler kernel-name fragments of each group of a device breakdown.
_GROUPS = (
    ("flash_fwd", ("fwd_wgmma_kernel", "fwd_f32_kernel")),
    ("flash_dq", ("dq_wgmma_kernel", "dq_f32_kernel")),
    ("flash_dkv", ("dkv_wgmma_kernel", "dkv_f32_kernel")),
    ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "matmul")),
)


def _device_breakdown(fn) -> dict:
    """Device time of one ``fn()`` from torch.profiler's CUDA trace, summed
    by kernel and grouped: the flash kernels, matmuls (cuBLAS), everything
    else."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    groups = {name: 0.0 for name, _ in _GROUPS}
    groups["other"] = 0.0
    for key, ms in by_kernel.items():
        k = key.lower()
        name = next((n for n, frags in _GROUPS if any(f in k for f in frags)), "other")
        groups[name] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": sum(by_kernel.values()), "groups_ms": groups,
            "top_kernels_ms": [[k[:120], ms] for k, ms in top]}


def phase_serve_full_width(card: str) -> dict:
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.ops.ring_attention import ring_attention
    from elasticdl_tpu_torch.serving.server import ServingServer

    width = dict(vocab=32768, dim=768, n_heads=12, n_layers=12, max_seq=1024, seq_len=1024)
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", **width)
    t0 = time.perf_counter()
    server = ServingServer(spec, max_batch=4, batch_buckets=[1, 4], seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    warm_s = server.warmup()
    log(f"[serve] GPT-2-small-width transformer_lm: init {init_s:.2f}s, warmup {warm_s:.2f}s")

    flush_ms = []
    runner = server._batcher._runner

    def timed_runner(batch, n_real):
        t = time.perf_counter()
        result = runner(batch, n_real)
        flush_ms.append((time.perf_counter() - t) * 1e3)
        return result

    server._batcher._runner = timed_runner
    rng = np.random.default_rng(0)
    sizes = [1, 2, 3, 4, 4, 3, 2, 1, 4, 4]
    requests = [rng.integers(0, width["vocab"], (n, width["seq_len"])).astype(np.int32)
                for n in sizes]
    before = server._batcher.stats()["flushes_by_bucket"]

    kernels.reset_counts()  # the main path's run starts here
    t_path = time.perf_counter()
    handles = [server._batcher.submit({"tokens": toks}) for toks in requests]
    outputs = [h.result(timeout_s=300.0)[0] for h in handles]
    path_s = time.perf_counter() - t_path
    launches = _count(fa.KERNEL)  # ... and ends here

    after = server._batcher.stats()["flushes_by_bucket"]
    flushes = sum(after[k] - before[k] for k in after)
    for toks, out in zip(requests, outputs):
        assert out.shape == (toks.shape[0], width["seq_len"], width["vocab"]), out.shape
        assert out.dtype == np.float32 and np.isfinite(out).all()
    assert flushes == len(flush_ms) and flushes > 0, (flushes, len(flush_ms))
    assert launches == width["n_layers"] * flushes, (launches, flushes)
    p50 = statistics.median(flush_ms)
    log(f"[serve] {len(requests)} requests, {sum(sizes)} sequences, {flushes} flushes in "
        f"{path_s:.3f}s; flash launches {launches} = 12 x {flushes}; "
        f"p50 flush {p50:.2f} ms on {card}")

    # One flush against the same model with the plain attention, on the card.
    model = server._live.state
    idx = sizes.index(4)
    tokens = torch.from_numpy(requests[idx]).cuda()

    def plain_attention(q, k, v, causal):
        return fa.flash_attention_plain(q, k, v, causal)[0]

    def copying_attention(q, k, v, causal):
        # q, k and v copied out of qkv (three copies per layer): the arm
        # that shows what reading qkv's row stride saves.
        return ring_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)

    with torch.inference_mode():
        plain = model(tokens, attention=plain_attention).cpu().numpy()
        # One bucket-4 forward: CUDA-event time (A/B/A against the copying
        # layout), the host's time to enqueue it, and the device time by
        # kernel.
        forward_ms = time_ms(lambda: model(tokens), iters=10, warmup=2)
        forward_copy_ms = time_ms(lambda: model(tokens, attention=copying_attention),
                                  iters=10, warmup=2)
        forward_ms_again = time_ms(lambda: model(tokens), iters=10, warmup=2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(tokens)
        enqueue_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        breakdown = _device_breakdown(lambda: model(tokens))
    log(f"[serve] bucket-4 forward: {forward_ms:.3f} ms, with q/k/v copies "
        f"{forward_copy_ms:.3f} ms, again {forward_ms_again:.3f} ms (CUDA events); host "
        f"enqueue {enqueue_ms:.3f} ms; device busy {breakdown['device_ms']:.3f} ms: "
        + json.dumps(breakdown["groups_ms"]))
    diff = np.abs(outputs[idx] - plain)
    log(f"[serve] flush vs plain attention: max |diff| {diff.max():.4g}, mean {diff.mean():.4g} "
        f"(bounds {MODEL_MAX_ABS}, {MODEL_MEAN_ABS})")
    assert diff.max() <= MODEL_MAX_ABS and diff.mean() <= MODEL_MEAN_ABS
    server.stop(grace=0.5)
    return {
        "init_s": init_s, "warmup_s": warm_s, "requests": len(requests),
        "sequences": sum(sizes), "flushes": flushes, "flash_launches": launches,
        "flush_ms": flush_ms, "p50_flush_ms": p50, "path_s": path_s,
        "forward_ms_bucket4": forward_ms, "forward_ms_bucket4_qkv_copies": forward_copy_ms,
        "forward_ms_bucket4_again": forward_ms_again, "forward_enqueue_ms": enqueue_ms,
        "forward_device": breakdown,
        "vs_plain_max_abs": float(diff.max()), "vs_plain_mean_abs": float(diff.mean()),
    }


# The training phase: tools/bench_all.py's transformer_lm configuration
# (GPT-2-small width, 1024 tokens, remat off, batch 16), bf16 compute over
# f32 weights, random weights from seed 0; nothing cut.
TRAIN_WIDTH = dict(vocab=32768, dim=768, n_heads=12, n_layers=12, seq_len=1024, max_seq=1024)
TRAIN_BATCH, TRAIN_STEPS = 16, 10
# One step's loss and gradients through the kernels against the same step
# through the plain attention forward and backward on the card: absolute
# loss difference and the largest per-parameter gradient error norm over
# the gradient's norm (both bf16 through 12 layers).  Set from the readings
# on the card (NVIDIA H100 80GB HBM3, 700 W: 1.5e-5 and 8.2e-3, pos_emb's
# gradient, which sums over every sequence of the batch) with room for
# run-to-run spread.
TRAIN_LOSS_ABS, TRAIN_GRAD_REL = 1e-3, 3e-2


def _planted_sequences(rng, n: int, seq_len: int, vocab: int) -> np.ndarray:
    """``synthetic_lm``'s planted next-token rule (elasticdl_tpu/data/
    synthetic.py): each token is (prev * 31 + 7) % vocab, or uniform noise
    with probability 0.1; n sequences of seq_len + 1 tokens."""
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(1, seq_len + 1):
        noise = rng.random(n) < 0.1
        toks[:, t] = np.where(noise, rng.integers(0, vocab, size=n),
                              (toks[:, t - 1] * 31 + 7) % vocab)
    return toks


class _PlainAttention(torch.autograd.Function):
    """Attention through the kernels' plain versions, forward and
    backward, on the card: the arm the kernels' training step is held
    against."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        o, lse = fa.flash_attention_plain(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from elasticdl_tpu_torch.ops import flash_attention as fa

        q, k, v, o, lse = ctx.saved_tensors
        return (*fa.flash_attention_bwd_plain(q, k, v, o, lse, do.contiguous(), ctx.causal), None)


def phase_train_full_width(card: str) -> dict:
    from elasticdl_tpu_torch.data.codecs import encode_lm_example
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    names = (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)
    layers = TRAIN_WIDTH["n_layers"]
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **TRAIN_WIDTH)
    trainer = Trainer(spec, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    n_batches = TRAIN_STEPS + 3
    toks = _planted_sequences(rng, TRAIN_BATCH * n_batches, TRAIN_WIDTH["seq_len"],
                              TRAIN_WIDTH["vocab"])
    records = [encode_lm_example(t) for t in toks]
    batches = [spec.feed(records[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(n_batches)]
    main_batches, extra = batches[:TRAIN_STEPS], batches[TRAIN_STEPS:]

    marks = []

    def timed(host_batches):
        # Step time: host clock between synchronised batch hand-outs.
        for batch in host_batches:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()  # the main path's run starts here
    state, metrics = trainer.run_train_steps(state, timed(main_batches))
    counts = {n: _count(n) for n in names}  # ... and ends here
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    accuracy = [float(m["accuracy"]) for m in metrics]
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    p50 = statistics.median(step_ms)
    log(f"[train] {TRAIN_STEPS} steps at batch {TRAIN_BATCH}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f"; accuracy {accuracy[-1]:.4f}")
    log(f"[train] step ms " + ", ".join(f"{x:.1f}" for x in step_ms)
        + f"; p50 {p50:.2f} ms; peak memory {peak_bytes / 2**30:.2f} GiB; launches "
        + json.dumps(counts) + f" on {card}")
    assert all(np.isfinite(losses)), losses
    assert statistics.mean(losses[-3:]) < statistics.mean(losses[:3]), losses
    assert counts == {n: layers * TRAIN_STEPS for n in names}, counts

    # One more step: its host enqueue against its wall, and its device
    # time by kernel group.
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = trainer.run_train_step(state, extra[0])
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    holder = [state]

    def one_step():
        holder[0] = trainer.run_train_step(holder[0], extra[1])[0]

    breakdown = _device_breakdown(one_step)
    state = holder[0]
    log(f"[train] one step: wall {wall_ms:.2f} ms, host enqueue {enqueue_ms:.2f} ms; "
        f"device busy {breakdown['device_ms']:.2f} ms: " + json.dumps(breakdown["groups_ms"]))

    # remat: each block's forward runs again in the backward.
    remat_trainer = Trainer(
        transformer_lm.model_spec(compute_dtype="bfloat16", remat=True, **TRAIN_WIDTH),
        device="cuda")
    kernels.reset_counts()
    state, remat_metrics = remat_trainer.run_train_step(state, extra[2])
    remat_counts = {n: _count(n) for n in names}
    log(f"[train] one step with remat: launches {json.dumps(remat_counts)}, loss "
        f"{float(remat_metrics['loss']):.4f}")
    assert remat_counts == {fa.KERNEL: 2 * layers, fa.DQ_KERNEL: layers,
                            fa.DKV_KERNEL: layers}, remat_counts

    # One step's loss and gradients: kernels against the plain attention.
    model = state.model
    batch = trainer.shard_batch(extra[2])

    def loss_and_grads(attention):
        model.zero_grad(set_to_none=True)
        loss = spec.loss(model(batch["tokens"], attention=attention), batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def plain_attention(q, k, v, causal):
        return _PlainAttention.apply(q, k, v, causal)

    loss_k, grads_k = loss_and_grads(transformer_lm.ring_attention)
    loss_p, grads_p = loss_and_grads(plain_attention)
    model.zero_grad(set_to_none=True)
    grad_rel = {n: ((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm()).item() for n in grads_p}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"[train] kernels vs plain attention, one step: loss {loss_k:.6f} vs {loss_p:.6f}; "
        f"largest gradient error norm / norm {grad_rel[worst]:.3g} ({worst}); limits "
        f"{TRAIN_LOSS_ABS}, {TRAIN_GRAD_REL}")
    assert abs(loss_k - loss_p) <= TRAIN_LOSS_ABS and grad_rel[worst] <= TRAIN_GRAD_REL
    return {
        "config": dict(TRAIN_WIDTH, batch=TRAIN_BATCH, remat=False, compute_dtype="bfloat16"),
        "init_s": init_s, "losses": losses, "accuracy": accuracy, "step_ms": step_ms,
        "p50_step_ms": p50, "peak_bytes": peak_bytes, "launches": counts,
        "step_wall_ms": wall_ms, "step_enqueue_ms": enqueue_ms, "step_device": breakdown,
        "remat_launches": remat_counts,
        "vs_plain": {"loss_kernels": loss_k, "loss_plain": loss_p,
                     "grad_rel": grad_rel, "worst": worst},
    }


# The job phase: the same width and batch as phase 4, run as the elastic
# job a user submits: 512 training records (8 tasks of 4 minibatches of 16,
# one epoch: 32 steps), 72 validation records (not a multiple of 16: every
# eval round ends on a masked tail), an eval round every 16 steps, a
# checkpoint every 16 steps (two kept), a replica hot-reloading each
# publish.  The replica's logits against the worker's final module:
# error norm over norm, the bf16 limit of TOL.
JOB_TRAIN, JOB_VAL = 512, 72
JOB = dict(minibatch_size=16, num_minibatches_per_task=4, num_epochs=1,
           evaluation_steps=16, checkpoint_steps=16, keep_checkpoint_max=2)
JOB_LOGITS_REL = 1e-2
# The step after the resume against the live state's step: the same
# weights, moments and batch through the same kernels.
JOB_RESUME_REL = 1e-5


class _RecordingMaster:
    """A master proxy that keeps the task reports it forwards."""

    def __init__(self, proxy):
        self._proxy = proxy
        self.reports = []

    def call(self, method, request):
        if method == "ReportTaskResult":
            self.reports.append(dict(request))
        return self._proxy.call(method, request)


def _check_job_launches(counts: dict, layers: int, train_steps: int, forwards: int) -> None:
    """12 forwards an eval step or reload forward, 12/12/12 a train step."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    want = {fa.KERNEL: layers * (train_steps + forwards), fa.DQ_KERNEL: layers * train_steps,
            fa.DKV_KERNEL: layers * train_steps}
    assert counts == want, (counts, want)


def _step_end_events(trainer) -> list:
    """Record an event on the stream before ``trainer``'s first train step
    or fused task and after each one, with the steps it ran (1, or a
    ``train_scan``'s T): the step time as the device sees it, gaps between
    steps included.  A scan runs its steps through the trainer's unwrapped
    step, so it is one call here."""
    events = []

    def timed(fn, n_steps):
        def run(state, batch):
            if not events:
                events.append((torch.cuda.Event(enable_timing=True), 0))
                events[0][0].record()
            result = fn(state, batch)
            events.append((torch.cuda.Event(enable_timing=True), n_steps(batch)))
            events[-1][0].record()
            return result

        return run

    trainer.train_step = timed(trainer.train_step, lambda batch: 1)
    trainer.train_scan = timed(trainer.train_scan,
                               lambda batch: int(next(iter(batch.values())).shape[0]))
    return events


def _event_intervals_ms(events: list) -> list:
    """Each step's time: an interval over n steps counts n times, at 1/n."""
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / n for (a, _), (b, n) in zip(events, events[1:])
            for _ in range(n)]


def phase_job(card: str, train_p50_ms: float) -> dict:
    """The elastic job on the card: RecordIO shards -> a MasterServer on
    localhost gRPC (TaskDispatcher, EvaluationService) -> one Worker over
    RpcMasterProxy -> train and eval steps through the kernels -> background
    checkpoints -> the published manifest -> a ServingServer hot-reloading
    it.  Then a second job over the same checkpoint directory resumes at
    the last step."""
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager, read_manifest
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.data.synthetic import synthetic_lm
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
    from elasticdl_tpu_torch.master.servicer import MasterServer, MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TASK_EVALUATION, TaskDispatcher
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.parallel.trainer import Trainer, outputs_to_numpy
    from elasticdl_tpu_torch.serving.server import ServingServer
    from elasticdl_tpu_torch.worker.worker import RpcMasterProxy, Worker

    out = os.path.join(REPO, "chiprun_out", "job")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    width = TRAIN_WIDTH
    seq, vocab, layers = width["seq_len"], width["vocab"], width["n_layers"]
    train = synthetic_lm(os.path.join(out, "train.rio"), JOB_TRAIN, seed=0, seq_len=seq,
                         vocab=vocab)
    val = synthetic_lm(os.path.join(out, "val.rio"), JOB_VAL, seed=1, seq_len=seq, vocab=vocab)
    ckpt = os.path.join(out, "ckpt")
    mb, per_task = JOB["minibatch_size"], JOB["minibatch_size"] * JOB["num_minibatches_per_task"]
    reader, eval_reader = create_data_reader(train), create_data_reader(val)

    class Mux:
        def read_records(self, shard):
            return (reader if shard.name == train else eval_reader).read_records(shard)

    def master(dispatcher, evaluation=None):
        servicer = MasterServicer(dispatcher, evaluation=evaluation)
        return servicer, MasterServer(servicer, port=0).start()

    # The yardstick in this call: the bare loop, run_train_steps over 12 of
    # the job's minibatches with no synchronisation, as the job runs them.
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **width)
    bare = Trainer(spec)
    bare_state = bare.init_state(0)
    records = list(reader.read_records(reader.create_shards(12 * mb)[0]))
    batches = [spec.feed(records[i * mb:(i + 1) * mb]) for i in range(12)]
    bare_state, _ = bare.run_train_steps(bare_state, batches[:2])
    bare_events = _step_end_events(bare)
    bare.run_train_steps(bare_state, batches[2:])
    bare_ms = _event_intervals_ms(bare_events)
    bare_p50 = statistics.median(bare_ms)
    del bare, bare_state

    servicer, server = master(
        TaskDispatcher(reader.create_shards(per_task), num_epochs=JOB["num_epochs"]),
        EvaluationService(eval_reader.create_shards(per_task), JOB["evaluation_steps"]))
    replica = ServingServer(spec, checkpoint_dir=ckpt, max_batch=4, batch_buckets=[1, 4],
                            poll_interval_s=0.1)
    replica.warmup()
    replica.start()
    config = JobConfig(model_def="transformer_lm.model_spec", training_data=train,
                       validation_data=val, checkpoint_dir=ckpt, **JOB)
    proxy = RpcMasterProxy(server.address, timeout_s=60.0)
    worker = Worker(config, proxy, Mux(), worker_id="chip-w0", spec=spec)
    step_events = _step_end_events(worker.trainer)
    try:
        kernels.reset_counts()  # the job's run starts here
        t0 = time.perf_counter()
        result = worker.run()
        job_s = time.perf_counter() - t0
        deadline = time.monotonic() + 120
        while replica.live_step != result["step"] and time.monotonic() < deadline:
            time.sleep(0.05)
        counts = {n: _count(n) for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}  # ... and ends here
        status = servicer.JobStatus({})
        reloads = list(replica.reload_log)
    finally:
        proxy.close()
        server.stop()
    steps = result["step"]
    n_tasks = JOB_TRAIN // per_task
    eval_steps = status["eval_rounds"] * -(-JOB_VAL // mb)
    assert status["done"] == n_tasks and status["duplicate_done"] == 0, status
    assert steps == JOB_TRAIN // mb, result
    assert status["eval_rounds"] >= 2 and np.isfinite(status["eval_metrics"]["loss"]), status
    manifest = read_manifest(ckpt)
    assert manifest is not None and manifest["step"] == steps, manifest
    applied = [r[0] for r in reloads]
    assert applied == [JOB["checkpoint_steps"], steps], applied
    _check_job_launches(counts, layers, steps, eval_steps + len(reloads))

    # The replica's answer against the worker's final module.
    toks = np.random.default_rng(3).integers(0, vocab, (1, seq)).astype(np.int32)
    served = replica._batcher.submit({"tokens": toks}).result(timeout_s=300.0)[0]
    ref = outputs_to_numpy(worker.trainer.run_predict_step(worker.state.model, {"tokens": toks}))
    logits_rel = float(np.linalg.norm(served - ref) / np.linalg.norm(ref))
    replica.stop(grace=0.5)
    assert np.isfinite(served).all() and logits_rel <= JOB_LOGITS_REL, logits_rel

    # The step time inside the job, the tokens, the phases, the checkpoints.
    step_ms = _event_intervals_ms(step_events)
    assert len(step_ms) == steps, (len(step_ms), steps)
    p50 = statistics.median(step_ms)
    tokens = steps * mb * seq
    train_window_s = sum(step_ms) / 1e3
    ckpt_log = sorted(worker.checkpoint_log, key=lambda r: r["step"])
    live_at = {r[0]: r[3] for r in reloads}
    publish_to_live = {r["step"]: live_at[r["step"]] - r["published_at"] for r in ckpt_log
                       if r["step"] in live_at}
    # The device snapshot on its own, synchronised (the loop only enqueues it).
    torch.cuda.synchronize()
    t = time.perf_counter()
    snap = worker.trainer.snapshot_state(worker.state)
    torch.cuda.synchronize()
    snapshot_sync_s = time.perf_counter() - t
    del snap
    log(f"[job] {n_tasks} tasks, {steps} steps, {status['eval_rounds']} eval rounds "
        f"(eval loss {status['eval_metrics']['loss']:.4f}), duplicates "
        f"{status['duplicate_done']}; manifest step {manifest['step']}; replica applied "
        f"{applied}; logits vs worker {logits_rel:.3g} (limit {JOB_LOGITS_REL})")
    log(f"[job] {tokens / job_s:,.0f} tokens/s over the job's wall ({job_s:.2f}s); "
        f"{tokens / train_window_s:,.0f} tokens/s over its steps; step p50 inside the job "
        f"{p50:.2f} ms (device events) vs the bare loop's {bare_p50:.2f} ms (device events, "
        f"{mb * seq / bare_p50 * 1e3:,.0f} tokens/s) and phase 4's {train_p50_ms:.2f} ms "
        f"(synchronised) on {card}")
    log("[job] bare loop step ms " + ", ".join(f"{x:.1f}" for x in bare_ms))
    log("[job] step ms (device events, step ends) " + ", ".join(f"{x:.1f}" for x in step_ms))
    log("[job] worker phases (s): " + json.dumps(result["phase_times"]))
    log("[job] launches " + json.dumps(counts) + f" = {layers} x ({steps} train steps; "
        f"{eval_steps} eval steps + {len(reloads)} reload forwards)")
    for r in ckpt_log:
        log(f"[job] checkpoint step {r['step']}: {r['bytes'] / 1e9:.3f} GB; device snapshot "
            f"enqueue {r['snapshot_s']:.4f}s, host copy {r['host_s']:.3f}s, "
            f"write {r['write_s']:.3f}s; publish-to-live "
            f"{publish_to_live[r['step']]:.3f}s")
    log(f"[job] device snapshot synchronised: {snapshot_sync_s * 1e3:.2f} ms; replica "
        f"restores (load + warm forward, s): "
        + ", ".join(f"step {r[0]}: {r[1]:.3f} (swap {r[2]:.3f} ms)" for r in reloads))

    # The last save is the final state: what the background save wrote
    # (snapshot, pinned host copy on a side stream while steps ran) equals
    # the live state exactly.
    saved = CheckpointManager(ckpt).restore(steps)
    live = worker.trainer.host_state(worker.state)
    assert sorted(live) == sorted(saved), (sorted(live), sorted(saved))
    torn = [k for k in saved if not np.array_equal(live[k], saved[k])]
    assert not torn, torn

    # A second job over the same checkpoint directory resumes at the last
    # step: an evaluation job, whose restored arrays must equal the saved
    # ones exactly.
    eval_servicer, eval_server = master(
        TaskDispatcher(eval_reader.create_shards(per_task), task_type=TASK_EVALUATION))
    eval_proxy = RpcMasterProxy(eval_server.address, timeout_s=60.0)
    recording = _RecordingMaster(eval_proxy)
    resumed = Worker(JobConfig(model_def="transformer_lm.model_spec", job_type="evaluation",
                               validation_data=val, checkpoint_dir=ckpt, **JOB),
                     recording, Mux(), worker_id="chip-w1", spec=spec)
    restore = {}
    restore_at_start = resumed._restore_at_start

    def spy():
        t = time.perf_counter()
        restore_at_start()
        restore["s"] = time.perf_counter() - t
        restore["arrays"] = resumed.trainer.host_state(resumed.state)

    resumed._restore_at_start = spy
    try:
        resumed_result = resumed.run()
    finally:
        eval_proxy.close()
        eval_server.stop()
    restored = restore["arrays"]
    exact = sorted(restored) == sorted(saved) and all(
        np.array_equal(restored[k], saved[k]) for k in saved)
    eval_loss = [r["metrics"]["loss"] for r in recording.reports if r["success"]]
    log(f"[job] resumed job: step {resumed_result['step']}, restore {restore['s']:.3f}s, "
        f"arrays equal the saved ones: {exact}; eval task losses "
        + ", ".join(f"{x:.4f}" for x in eval_loss))
    # Its eval round scores the same state on the same records as the first
    # job's last round: the count-weighted means agree (bf16, same kernels).
    weights = [r["weight"] for r in recording.reports if r["success"]]
    resumed_loss = float(np.dot(eval_loss, weights) / np.sum(weights))
    log(f"[job] resumed eval loss {resumed_loss:.6f} vs the first job's last round "
        f"{status['eval_metrics']['loss']:.6f}")
    assert resumed_result["step"] == steps and exact
    assert abs(resumed_loss - status["eval_metrics"]["loss"]) <= 1e-3 * abs(resumed_loss)
    assert eval_servicer.JobStatus({})["done"] == -(-JOB_VAL // per_task)

    # The restored state trains on: its step 33 against the live state's on
    # the same batch.  The same loss (the same parameters), and the same
    # parameters and AdamW moments after the step (limit on the error norm
    # over the norm; restored moments or count that were wrong would miss
    # by orders of magnitude more).
    step_fn = resumed.trainer.run_train_step
    live_state, live_m = step_fn(worker.state, batches[0])
    resumed_state, resumed_m = step_fn(resumed.state, batches[0])
    live_loss, resumed_step_loss = float(live_m["loss"]), float(resumed_m["loss"])
    after_live = resumed.trainer.host_state(live_state)
    after_resumed = resumed.trainer.host_state(resumed_state)
    after_rel = max(
        float(np.linalg.norm(after_resumed[k] - after_live[k].astype(np.float64))
              / max(np.linalg.norm(after_live[k].astype(np.float64)), 1e-30))
        for k in after_live)
    log(f"[job] step {resumed_state.step} after the restore: loss {resumed_step_loss:.6f} vs "
        f"the live state's {live_loss:.6f}; state after it vs the live one's: worst error "
        f"norm over norm {after_rel:.3g} (limit {JOB_RESUME_REL})")
    assert resumed_state.step == live_state.step == steps + 1
    assert abs(resumed_step_loss - live_loss) <= JOB_RESUME_REL * abs(live_loss)
    assert after_rel <= JOB_RESUME_REL, after_rel
    del worker, resumed, live_state, resumed_state
    # 2.7 GB of checkpoints: too much to keep in chiprun_out/.
    shutil.rmtree(ckpt)
    return {
        "config": dict(width, **JOB, train_records=JOB_TRAIN, val_records=JOB_VAL,
                       compute_dtype="bfloat16", remat=False),
        "tasks": n_tasks, "steps": steps, "eval_rounds": status["eval_rounds"],
        "eval_metrics": status["eval_metrics"], "duplicate_done": status["duplicate_done"],
        "manifest_step": manifest["step"], "replica_applied": applied,
        "logits_rel": logits_rel, "launches": counts, "eval_steps": eval_steps,
        "job_s": job_s, "tokens": tokens, "tokens_per_s_job": tokens / job_s,
        "tokens_per_s_steps": tokens / train_window_s, "step_ms": step_ms,
        "p50_step_ms": p50, "phase4_p50_step_ms": train_p50_ms,
        "bare_step_ms": bare_ms, "bare_p50_step_ms": bare_p50,
        "phase_times": result["phase_times"], "checkpoints": ckpt_log,
        "publish_to_live_s": publish_to_live, "snapshot_sync_s": snapshot_sync_s,
        "replica_reloads": reloads, "restore_s": restore["s"],
        "resumed_step": resumed_result["step"], "resumed_eval_losses": eval_loss,
        "resumed_eval_loss": resumed_loss, "step_after_restore_loss": resumed_step_loss,
        "live_step_loss": live_loss, "state_after_restore_rel": after_rel,
    }


PROC_JOB = "chip8"
# The first incarnation stalls at its first task boundary past the first
# checkpoint (it is SIGKILLed there); the relaunch stalls 2 s at its first
# boundary a task later (it is SIGTERMed there).  Chaos hooks of the worker
# loop, each matching one pod name.
PROC_CHAOS = (f"stall:worker={PROC_JOB}-worker-0,point=task,step={JOB['checkpoint_steps']},"
              f"ms=600000;stall:worker={PROC_JOB}-worker-0-r1,point=task,"
              f"step={JOB['checkpoint_steps'] + JOB['num_minibatches_per_task']},ms=2000")


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as f:
        return f.read()


def _worker_events(text: str) -> dict:
    """A worker process's ``[worker-event]`` lines, by kind."""
    out = {}
    for line in text.splitlines():
        if line.startswith("[worker-event] "):
            event = json.loads(line[len("[worker-event] "):])
            out[event["event"]] = event
    return out


def _log_time(text: str, needle: str) -> float:
    """The wall time of the first log line holding ``needle`` (the log
    format's ``[YYYY-mm-dd HH:MM:SS,mmm]`` prefix, local time)."""
    line = next(x for x in text.splitlines() if needle in x)
    stamp = line[1:24]
    return time.mktime(time.strptime(stamp[:19], "%Y-%m-%d %H:%M:%S")) + int(stamp[20:23]) / 1e3


def _wait_for(cond, what: str, proc, timeout_s: float = 300.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        if proc.poll() is not None:
            raise AssertionError(f"the job exited {proc.returncode} before {what}")
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout_s:.0f}s waiting for {what}")


def _cli_job(job_name: str, ckpt: str, pods: str, chaos: str, *flags: str) -> list:
    """The CLI's local-mode command for phase 7's files at phase 4's width."""
    out = os.path.join(REPO, "chiprun_out", "job")
    train, val = os.path.join(out, "train.rio"), os.path.join(out, "val.rio")
    assert os.path.exists(train) and os.path.exists(val), "phase 7 writes the job's data"
    params = ";".join(f"{k}={v}" for k, v in TRAIN_WIDTH.items())
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={job_name}", "--model_def=transformer_lm.model_spec",
           f"--model_params={params};compute_dtype=bfloat16;remat=false",
           "--learning_rate=3e-4", f"--training_data={train}", f"--validation_data={val}",
           f"--checkpoint_dir={ckpt}", f"--pod_log_dir={pods}", "--max_worker_relaunch=2",
           f"--chaos={chaos}", *flags]
    return cmd + [f"--{k}={v}" for k, v in JOB.items()]


def _start_cli(cmd: list, log_path: str):
    """The CLI in its own session (so a failure can kill it and its worker
    processes at once), on the card: no ``ELASTICDL_TORCH_DEVICE``."""
    env = {k: v for k, v in os.environ.items() if k != "ELASTICDL_TORCH_DEVICE"}
    with open(log_path, "w") as cli_log:
        return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=cli_log,
                                stderr=subprocess.STDOUT, start_new_session=True)


def _stop_cli(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)  # the CLI and its worker processes
        proc.wait()


def phase_process_job(card: str, job_p50_ms: float) -> dict:
    """The process-level elastic job on the card, through the CLI's local
    mode: ``python -m elasticdl_tpu_torch.client.main train`` in a
    subprocess (a ``Master`` with a ``ProcessPodBackend``, one worker
    process on the card) over phase 7's RecordIO files at phase 4's width,
    with a ``ServingServer`` in this process polling the manifest.  The
    first worker is SIGKILLed once the manifest names the first checkpoint:
    the pod manager relaunches it (budget charged), and the relaunch joins
    from that step.  The relaunch is SIGTERMed during a later task: it
    snapshots, exits 3, is relaunched without charging the budget, and the
    last incarnation resumes from the snapshot and finishes the job."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.serving.server import ServingServer

    out = os.path.join(REPO, "chiprun_out", "job")
    ckpt, pods = os.path.join(out, "ckpt8"), os.path.join(out, "pods")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(pods, ignore_errors=True)
    width = TRAIN_WIDTH
    seq, layers, mb = width["seq_len"], width["n_layers"], JOB["minibatch_size"]
    n_tasks = JOB_TRAIN // (mb * JOB["num_minibatches_per_task"])
    every = JOB["checkpoint_steps"]
    torch.cuda.empty_cache()  # the worker processes share the card with this one
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **width)
    replica = ServingServer(spec, checkpoint_dir=ckpt, max_batch=4, batch_buckets=[1, 4],
                            poll_interval_s=0.1)
    replica.warmup()
    replica.start()
    first, second, third = (f"{PROC_JOB}-worker-0", f"{PROC_JOB}-worker-0-r1",
                            f"{PROC_JOB}-worker-0-r2")
    pod_log = {n: os.path.join(pods, f"{n}.log") for n in (first, second, third)}
    cli_path = os.path.join(out, "cli.log")
    t0 = time.time()
    proc = _start_cli(_cli_job(PROC_JOB, ckpt, pods, PROC_CHAOS), cli_path)
    try:
        # SIGKILL the first worker once the manifest names the first
        # checkpoint (it stalls at its next task boundary meanwhile).
        _wait_for(lambda: (read_manifest(ckpt) or {}).get("step") == every,
                  f"the step-{every} checkpoint", proc)
        first_pid = _worker_events(_read(pod_log[first]))["ready"]["pid"]
        t_kill = time.time()
        os.kill(first_pid, signal.SIGKILL)
        # SIGTERM the relaunch during a later task (its 2 s stall).
        _wait_for(lambda: "[graftchaos] stall" in _read(pod_log[second]),
                  "the relaunch's later task", proc)
        second_pid = _worker_events(_read(pod_log[second]))["ready"]["pid"]
        t_term = time.time()
        os.kill(second_pid, signal.SIGTERM)
        rc = proc.wait(timeout=600)
        wall_s = time.time() - t0
        deadline = time.monotonic() + 120
        final = (read_manifest(ckpt) or {}).get("step")
        while replica.live_step != final and time.monotonic() < deadline:
            time.sleep(0.05)
        reloads = list(replica.reload_log)
        toks = np.random.default_rng(3).integers(0, width["vocab"], (1, seq)).astype(np.int32)
        served = replica._batcher.submit({"tokens": toks}).result(timeout_s=300.0)[0]
    finally:
        _stop_cli(proc)
        replica.stop(grace=0.5)
    cli, logs = _read(cli_path), {n: _read(p) for n, p in pod_log.items()}
    assert rc == 0, f"the job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    ev = {n: _worker_events(text) for n, text in logs.items()}

    # The job: every task done once, none abandoned; the relaunches.
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0, status
    assert np.isfinite(status["eval_metrics"]["loss"]), status
    for needle in (f"pod {first} exited rc=-9 -> Failed",
                   f"relaunching failed pod {first} as {second} (relaunch 1/2)",
                   f"pod {second} exited rc=3 -> Restart",
                   f"relaunching failed pod {second} as {third} (relaunch 1/2)",
                   f"pod {third} exited rc=0 -> Succeeded"):
        assert needle in cli, needle
    # The SIGKILLed worker's relaunch joined from the published step; the
    # SIGTERMed one snapshotted, and the last incarnation joined from it.
    assert f"joined from checkpoint step {every}" in logs[second]
    assert ev[second]["ready"]["joined_step"] == every, ev[second]
    snap = int(logs[second].split("preemption snapshot at step ", 1)[1].split()[0])
    assert snap > every and ev[third]["ready"]["joined_step"] == snap, (snap, ev[third])
    assert f"joined from checkpoint step {snap}" in logs[third]
    summary = ev[third]["summary"]
    manifest = read_manifest(ckpt)
    assert manifest["step"] == summary["step"] == snap + summary["steps"], (manifest, summary)
    assert summary["step"] >= JOB_TRAIN // mb, summary
    # The replica applied published steps only, in order, up to the last.
    published = [int(line.rsplit(" ", 1)[1]) for name in (first, second, third)
                 for line in logs[name].splitlines() if "published checkpoint step" in line]
    applied = [r[0] for r in reloads]
    assert applied and applied[-1] == manifest["step"], (applied, manifest)
    assert applied == sorted(set(applied)) and set(applied) <= set(published), (
        applied, published)
    assert served.shape == (1, seq, width["vocab"]) and np.isfinite(served).all(), served.shape
    # The last incarnation's launches: 12 a forward (train and eval steps),
    # 12 dq and 12 dkv a train step.
    launches = summary["launches"]
    _check_job_launches(launches, layers, summary["steps"], summary["eval_steps"])

    # Times: the kill's and the preemption's recovery, decomposed.
    def recovery(pod: str, t_signal: float, first_key: str, first_at: float) -> dict:
        ready = ev[pod]["ready"]
        return dict({first_key: first_at - t_signal,
                     "relaunch_start_s": ready["started_at"] - t_signal},
                    **{k: ready[k] for k in ("boot_s", "device_init_s", "restore_s", "init_s",
                                             "read_s", "load_s")},
                    recover_s=ev[pod]["first_step"]["at"] - t_signal)

    kill = recovery(second, t_kill, "detect_s", _log_time(cli, f"pod {first} exited"))
    term = recovery(third, t_term, "exit_s", _log_time(cli, f"pod {second} exited"))
    step_ms = summary["step_ms"]
    assert len(step_ms) == summary["steps"] - 1, (len(step_ms), summary["steps"])
    p50 = statistics.median(step_ms)
    tokens = manifest["step"] * mb * seq
    log(f"[proc] {n_tasks} tasks done, {status['abandoned']} abandoned, "
        f"{status['duplicate_done']} duplicates, {status['eval_rounds']} eval rounds (eval loss "
        f"{status['eval_metrics']['loss']:.4f}); SIGKILL at step-{every} publish -> {second} "
        f"joined from {every}; SIGTERM -> snapshot at {snap}, exit 3 -> {third} joined from "
        f"{snap}; final step {manifest['step']}; published {published}; replica applied "
        f"{applied}")
    for name, r, first_key in (("SIGKILL", kill, "detect"), ("SIGTERM", term, "exit")):
        log(f"[proc] {name} recovery (s): {first_key} {r[first_key + '_s']:.3f}, relaunched "
            f"process started {r['relaunch_start_s']:.3f}, boot {r['boot_s']:.3f}, CUDA "
            f"context {r['device_init_s']:.3f}, restore {r['restore_s']:.3f} (seeded init "
            f"{r['init_s']:.3f}, read {r['read_s']:.3f}, load {r['load_s']:.3f}), first step "
            f"done {r['recover_s']:.3f} after the signal; on {card}")
    log(f"[proc] job wall {wall_s:.2f}s (three worker boots, the injected stalls, the "
        f"saves); {tokens / wall_s:,.0f} tokens/s of the final model's {manifest['step']} "
        f"steps over it; last incarnation: {summary['steps']} steps, {summary['eval_steps']} "
        f"eval steps, {(len(step_ms)) * mb * seq / (sum(step_ms) / 1e3):,.0f} tokens/s over "
        f"its steps, step p50 {p50:.2f} ms (device events) vs phase 7's job "
        f"{job_p50_ms:.2f} ms; on {card}")
    log("[proc] last incarnation step ms " + ", ".join(f"{x:.1f}" for x in step_ms))
    log("[proc] last incarnation launches " + json.dumps(launches) + f" = {layers} x "
        f"({summary['steps']} train steps; {summary['eval_steps']} eval steps)")
    log("[proc] last incarnation phases (s): " + json.dumps(summary["phase_times"]))
    shutil.rmtree(ckpt)  # 2.7 GB of checkpoints: too much to keep in chiprun_out/
    return {
        "tasks": n_tasks, "status": {k: status[k] for k in (
            "done", "abandoned", "duplicate_done", "eval_rounds", "eval_metrics")},
        "snapshot_step": snap, "final_step": manifest["step"], "published": published,
        "replica_applied": applied, "kill": kill, "term": term, "wall_s": wall_s,
        "tokens_per_s_wall": tokens / wall_s, "last": summary, "p50_step_ms": p50,
        "launches": launches,
        "kernels": {n: launches.get(n, 0) for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)},
    }


STANDBY_JOB = "chip9"


def phase_process_job_standby(card: str, cold_recover_s: float) -> dict:
    """Phase 8's SIGKILL with a warm standby (``--warm_worker_standby``):
    the pod manager parks a spare worker process that has paid its imports
    and, when the first worker is SIGKILLed at the first checkpoint (the
    same chaos stall holds it there), adopts the spare under the relaunch's
    name instead of booting a process.  The job finishes; the adopted
    process's launch counts are its own steps'."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.ops import flash_attention as fa

    out = os.path.join(REPO, "chiprun_out", "job")
    ckpt, pods = os.path.join(out, "ckpt9"), os.path.join(out, "pods9")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(pods, ignore_errors=True)
    every, layers = JOB["checkpoint_steps"], TRAIN_WIDTH["n_layers"]
    n_tasks = JOB_TRAIN // (JOB["minibatch_size"] * JOB["num_minibatches_per_task"])
    first, second = f"{STANDBY_JOB}-worker-0", f"{STANDBY_JOB}-worker-0-r1"
    cli_path = os.path.join(out, "cli9.log")
    chaos = f"stall:worker={first},point=task,step={every},ms=600000"
    proc = _start_cli(_cli_job(STANDBY_JOB, ckpt, pods, chaos, "--warm_worker_standby=true"),
                      cli_path)
    try:
        _wait_for(lambda: (read_manifest(ckpt) or {}).get("step") == every,
                  f"the step-{every} checkpoint", proc)
        # Only a warmed spare is adopted (one still importing is replaced
        # by a cold spawn); the first worker stalls meanwhile.
        _wait_for(lambda: "standby warmed" in _read(os.path.join(pods, "standby.go.1.log")),
                  "the warm spare", proc)
        first_pid = _worker_events(_read(os.path.join(pods, f"{first}.log")))["ready"]["pid"]
        t_kill = time.time()
        os.kill(first_pid, signal.SIGKILL)
        rc = proc.wait(timeout=600)
    finally:
        _stop_cli(proc)
    cli, adopted = _read(cli_path), _read(os.path.join(pods, f"{second}.log"))
    assert rc == 0, f"the job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0, status
    for needle in (f"pod {first} exited rc=-9 -> Failed",
                   f"relaunching failed pod {first} as {second} (relaunch 1/2)",
                   f"as {second}", f"pod {second} exited rc=0 -> Succeeded"):
        assert needle in cli, needle
    assert f"standby adopted as {second}" in adopted and (
        f"joined from checkpoint step {every}" in adopted), adopted[-3000:]
    ev = _worker_events(adopted)
    summary, ready = ev["summary"], ev["ready"]
    assert ready["joined_step"] == every and summary["step"] >= JOB_TRAIN // JOB["minibatch_size"]
    _check_job_launches(summary["launches"], layers, summary["steps"], summary["eval_steps"])
    warm = dict({"detect_s": _log_time(cli, f"pod {first} exited") - t_kill,
                 "adopted_s": _log_time(cli, "adopted warm standby") - t_kill},
                **{k: ready[k] for k in ("device_init_s", "restore_s", "init_s", "read_s",
                                         "load_s")},
                recover_s=ev["first_step"]["at"] - t_kill)
    log(f"[standby] SIGKILL recovery with a warm standby (s): detect {warm['detect_s']:.3f}, "
        f"spare adopted {warm['adopted_s']:.3f}, CUDA context {warm['device_init_s']:.3f}, "
        f"restore {warm['restore_s']:.3f} (seeded init {warm['init_s']:.3f}, read "
        f"{warm['read_s']:.3f}, load {warm['load_s']:.3f}), first step done "
        f"{warm['recover_s']:.3f} after the kill, against phase 8's cold relaunch "
        f"{cold_recover_s:.3f}; {n_tasks} tasks done, final step {summary['step']}; "
        f"launches {json.dumps(summary['launches'])} = {layers} x ({summary['steps']} train "
        f"steps; {summary['eval_steps']} eval steps); on {card}")
    shutil.rmtree(ckpt)
    return {"warm": warm, "last": summary,
            "kernels": {n: summary["launches"].get(n, 0)
                        for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scrape_launches(metrics_port: int) -> float:
    from elasticdl_tpu_torch.common.metrics_http import fetch

    fam = fetch(f"localhost:{metrics_port}", timeout_s=30.0).get("edl_kernel_launches_total")
    samples = fam["samples"] if fam else []
    return sum(x["value"] for x in samples if x["labels"].get("kernel") == "flash_attention_fwd")


def phase_grpc_replica() -> dict:
    from elasticdl_tpu_torch.serving.client import ServingClient

    os.environ["GRAFT_WIRESAN"] = "1"  # both ends validate every message
    port, metrics_port = _free_port(), _free_port()
    cfg = {
        "model_def": "transformer_lm.model_spec",
        "model_params": {"seq_len": 128, "max_seq": 128},
        "max_batch": 2, "batch_buckets": [1, 2], "device": "cuda",
        "base_port": port, "metrics_base_port": metrics_port,
    }
    env = dict(os.environ, ELASTICDL_SERVING_CONFIG=json.dumps(cfg), ELASTICDL_WORKER_SLOT="0")
    out_path = os.path.join(REPO, "chiprun_out", "replica.log")
    with open(out_path, "w") as replica_log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.serving.main"],
            cwd=REPO, env=env, stdout=replica_log, stderr=subprocess.STDOUT,
        )
        client = ServingClient(f"localhost:{port}")
        try:
            t0 = time.perf_counter()
            client.wait_ready(300.0)
            ready_s = time.perf_counter() - t0
            launches0 = _scrape_launches(metrics_port)
            flushes0 = sum(client.model_info()["batcher"]["flushes_by_bucket"].values())
            rng = np.random.default_rng(1)
            latencies = []
            for n in (1, 2, 1, 2):
                toks = rng.integers(0, 8192, (n, 128)).astype(np.int32)
                t = time.perf_counter()
                out = client.predict_outputs({"tokens": toks}, timeout_s=120.0)
                latencies.append((time.perf_counter() - t) * 1e3)
                assert out.shape == (n, 128, 8192) and np.isfinite(out).all(), out.shape
            info = client.model_info()
            flushes = sum(info["batcher"]["flushes_by_bucket"].values()) - flushes0
            launches = _scrape_launches(metrics_port) - launches0
            assert info["model"] == "transformer_lm" and info["requests"] == 4
            assert flushes > 0 and launches == 2 * flushes, (launches, flushes)
        finally:
            client.close()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise
    assert rc == 0, f"replica exited {rc}; see {out_path}"
    log(f"[grpc] replica ready in {ready_s:.2f}s; 4 Predicts + ModelInfo; "
        f"{flushes} flushes, {int(launches)} flash launches; Predict wall ms "
        + ", ".join(f"{x:.1f}" for x in latencies))
    return {"ready_s": ready_s, "flushes": flushes, "flash_launches": launches,
            "predict_ms": latencies}


# Phase 10: DeepFM on Criteo at the JAX bench's width (bench.py:288-294):
# 65536 buckets a feature, embedding dim 8, MLP (400, 400), global batch
# 8192, bf16 compute over f32 parameters, the native preprocessing feed,
# Adam lr 1e-3.  The end-to-end run follows tools/bench_e2e.py: a RecordIO
# file of 2 tasks x 8 minibatches x 8192 records, read for 9 epochs (18
# tasks), the first 2 excluded.
DFM_WIDTH = dict(buckets_per_feature=65536, embedding_dim=8, hidden=(400, 400))
DFM_BATCH, DFM_MB_PER_TASK, DFM_FILE_TASKS = 8192, 8, 2
DFM_WARM_TASKS, DFM_MEASURE_TASKS = 2, 16
DFM_WARM_STEPS, DFM_STEPS = 5, 30
DFM_VAL = 20000  # 2 full minibatches and a masked tail of 3616
# Card against CPU (both f32, TF32 off): logits' and each gradient's error
# norm over norm; the bf16 card model against the f32 CPU one, the same
# readings (bf16 keeps ~3 digits through two 400-wide layers).
DFM_F32_REL, DFM_BF16_REL = 1e-4, 5e-2


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _dfm_loss_and_grads(spec, model, batch: dict) -> tuple:
    """Logits, loss and the table's and MLP's gradients of one step."""
    from elasticdl_tpu_torch.parallel.trainer import MASK_KEY

    batch = dict(batch)
    mask = batch.pop(MASK_KEY)
    model.zero_grad(set_to_none=True)
    logits = spec.apply(model, batch, train=True)
    loss = spec.loss(logits, batch, mask=mask)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return logits.detach(), loss.detach(), grads


# Profiler kernel-name fragments of the DeepFM step's groups: the gather
# (index_select's kernel), the scatter-add (index_add's kernel and the fill
# that zeroes the dense table gradient under it, the step's only large
# fill), Adam (foreach kernels), GEMMs (cuBLAS).
_DFM_GROUPS = (
    ("gather", ("gather_kernel", "indexselect", "index_select")),
    ("scatter_add", ("indexfunc", "index_add", "indexput", "index_put", "scatter",
                     "fillfunctor<float>")),
    ("adam", ("multi_tensor_apply", "adam")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "matmul", "sm90_")),
)


def _dfm_breakdown(fn, kernel_groups=_DFM_GROUPS) -> dict:
    """One ``fn()`` under torch.profiler: device time grouped by
    ``kernel_groups`` (DeepFM's: gather, scatter-add, Adam, GEMMs) and the
    rest, the top kernels, and the host's top operators by self time (under
    the profiler, which slows them), with the count of kernels launched."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel, by_op, launches = {}, {}, 0
    for e in prof.key_averages():
        # A user annotation ("Optimizer.step#Adam.step") carries the device
        # time of the kernels inside it again; the buffer requests are the
        # profiler's own.
        annotation = getattr(e, "is_user_annotation", False) or "#" in e.key
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and not annotation and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
            launches += e.count
        elif e.self_cpu_time_total > 0 and e.key != "Activity Buffer Request":
            by_op[e.key] = by_op.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["rest"] = 0.0
    for key, ms in by_kernel.items():
        k = key.lower()
        name = next((n for n, frags in kernel_groups if any(f in k for f in frags)), "rest")
        groups[name] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]
    host = sorted(by_op.items(), key=lambda kv: -kv[1])[:14]
    return {"device_ms": sum(by_kernel.values()), "groups_ms": groups, "kernels": launches,
            "top_kernels_ms": [[k[:120], ms] for k, ms in top],
            "host_ms": sum(by_op.values()), "top_host_ops_ms": [[k[:80], ms] for k, ms in host]}


def _dfm_e2e(spec, train: str, reader, ingest_threads: int, epochs: int,
             val: str = "") -> dict:
    """tools/bench_e2e.py's run in the port: MasterServicer + a timing
    DirectMasterProxy + one Worker with prep-ahead over the RecordIO file;
    examples/s over the training reports' timestamps past the warm-up
    tasks.  ``val``: one eval round at the last step, on that file."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
    from elasticdl_tpu_torch.worker.worker import DirectMasterProxy, Worker

    per_task = DFM_BATCH * DFM_MB_PER_TASK
    total_steps = epochs * DFM_FILE_TASKS * DFM_MB_PER_TASK
    evaluation = None
    if val:
        evaluation = EvaluationService(create_data_reader(val).create_shards(per_task),
                                       evaluation_steps=total_steps)
    dispatcher = TaskDispatcher(create_data_reader(train).create_shards(per_task),
                                num_epochs=epochs)
    servicer = MasterServicer(dispatcher, evaluation=evaluation)
    stamps, reports = [], []

    class TimingProxy(DirectMasterProxy):
        def call(self, method, request):
            resp = super().call(method, request)
            if method == "ReportTaskResult":
                reports.append(dict(request))
                if request.get("task_type") == "training":
                    stamps.append(time.perf_counter())
            return resp

    config = JobConfig(
        model_def="deepfm.model_spec", training_data=train, validation_data=val,
        minibatch_size=DFM_BATCH, num_minibatches_per_task=DFM_MB_PER_TASK,
        num_epochs=epochs, ingest_threads=ingest_threads, task_pipelining=True,
        prep_depth=2, evaluation_steps=total_steps if val else 0)
    worker = Worker(config, TimingProxy(servicer), reader, worker_id="chip-dfm", spec=spec)
    t0 = time.perf_counter()
    result = worker.run()
    wall = time.perf_counter() - t0
    status = servicer.JobStatus({})
    n_tasks = epochs * DFM_FILE_TASKS
    assert status["done"] == n_tasks and len(stamps) == n_tasks, (status, len(stamps))
    assert result["step"] == total_steps, result
    measured = len(stamps) - DFM_WARM_TASKS
    elapsed = stamps[-1] - stamps[DFM_WARM_TASKS - 1]
    losses = [r["metrics"]["loss"] for r in reports if r.get("task_type") == "training"]
    assert all(r["success"] for r in reports) and np.isfinite(losses).all(), losses
    from elasticdl_tpu_torch.data.ingest_pool import resolve_threads

    return {
        "ingest_threads": resolve_threads(ingest_threads),
        "examples_per_s": measured * per_task / elapsed, "tasks_measured": measured,
        "examples_measured": measured * per_task, "elapsed_s": elapsed, "wall_s": wall,
        "steps": result["step"], "losses": losses, "phase_times": result["phase_times"],
        "eval_rounds": status.get("eval_rounds", 0), "eval_metrics": status.get("eval_metrics", {}),
    }


def _dfm_cli(train: str, val: str, out: str) -> dict:
    """``python -m elasticdl_tpu_torch.client.main train
    --model_def=deepfm.model_spec`` at the bench width (the model's
    defaults) for one epoch: a ``Master`` in the CLI's process, one worker
    process on the card, an eval round and a checkpoint at step 16."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest

    ckpt, pods = os.path.join(out, "ckpt"), os.path.join(out, "pods")
    steps = DFM_FILE_TASKS * DFM_MB_PER_TASK
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           "--job_name=chip10", "--model_def=deepfm.model_spec", "--learning_rate=1e-3",
           f"--training_data={train}", f"--validation_data={val}",
           f"--minibatch_size={DFM_BATCH}", f"--num_minibatches_per_task={DFM_MB_PER_TASK}",
           "--num_epochs=1", f"--evaluation_steps={steps}", f"--checkpoint_steps={steps}",
           f"--checkpoint_dir={ckpt}", f"--pod_log_dir={pods}"]
    log_path = os.path.join(out, "cli.log")
    t = time.perf_counter()
    proc = _start_cli(cmd, log_path)
    try:
        rc = proc.wait(timeout=300)
    finally:
        _stop_cli(proc)
    wall = time.perf_counter() - t
    text = _read(log_path)
    assert rc == 0, f"the DeepFM CLI job exited {rc}; see {log_path}"
    line = next(x for x in text.splitlines() if "job finished: " in x)
    status = ast.literal_eval(line.split("job finished: ", 1)[1])
    events = _worker_events(_read(os.path.join(pods, "chip10-worker-0.log")))
    summary = events["summary"]
    manifest = read_manifest(ckpt)
    log(f"[deepfm] CLI job: rc {rc} in {wall:.1f} s; {status['done']} tasks, step "
        f"{summary['step']}, eval " + json.dumps(status["eval_metrics"])
        + f"; manifest step {manifest['step']}; worker boot "
        f"{events['ready'].get('boot_s', float('nan')):.2f} s")
    assert status["done"] == DFM_FILE_TASKS and summary["step"] == steps
    assert status["eval_rounds"] >= 1 and 0.0 < status["eval_metrics"]["auc"] < 1.0
    assert manifest["step"] == steps
    shutil.rmtree(ckpt)  # 0.44 GB a checkpoint: too much to keep in chiprun_out/
    return {"wall_s": wall, "status_eval": status["eval_metrics"], "summary": summary,
            "manifest_step": manifest["step"]}


def phase_deepfm(card: str) -> dict:
    """DeepFM on the card: (a) the card against the CPU, an out-of-range
    id, the native decode against the plain one; (b) the device step by
    bench.py's protocol with a profile split; (c) the end-to-end job with
    the ingest pool on auto and at one thread; (d) one eval round with a
    masked tail after a two-epoch job."""
    import shutil

    from elasticdl_tpu_torch.data import codecs
    from elasticdl_tpu_torch.data.reader import RecordIODataReader
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.ops.embedding import gather_rows, logical_rows
    from elasticdl_tpu_torch.parallel.trainer import MASK_KEY, Trainer
    from elasticdl_tpu_torch.ps import host_store

    out = os.path.join(REPO, "chiprun_out", "deepfm")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t = time.perf_counter()
    train = synthetic_criteo(os.path.join(out, "train.rio"),
                             DFM_FILE_TASKS * DFM_MB_PER_TASK * DFM_BATCH, seed=11,
                             container="recordio")
    val = synthetic_criteo(os.path.join(out, "val.rio"), DFM_VAL, seed=12, container="recordio")
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    host_store._load()  # builds the native library from the checkout
    build_s = time.perf_counter() - t
    reader = RecordIODataReader(os.path.join(out, "*.rio"))
    records = reader.read_records_packed(reader.create_shards(DFM_BATCH)[0])
    assert len(records) == DFM_BATCH
    log(f"[deepfm] data: {os.path.getsize(train) >> 20} MiB train, {DFM_VAL} val records in "
        f"{gen_s:.1f}s; native library ready in {build_s:.1f}s")

    # (a) The decode: native against plain on 8192 records, bit for bit;
    # both timed on this host.
    buckets = DFM_WIDTH["buckets_per_feature"]
    native = codecs.criteo_feed_pre(records, buckets)
    t = time.perf_counter()
    plain = codecs.criteo_feed_pre_plain(list(records), buckets)
    plain_decode_ms = (time.perf_counter() - t) * 1e3
    for k in ("dense", "cat", "labels"):
        assert native[k].dtype == plain[k].dtype and native[k].tobytes() == plain[k].tobytes(), k
    t = time.perf_counter()
    for _ in range(20):
        codecs.criteo_feed_pre(records, buckets)
    native_decode_ms = (time.perf_counter() - t) * 1e3 / 20
    t = time.perf_counter()
    for _ in range(5):
        reader.read_records_packed(reader.create_shards(DFM_BATCH)[0])
    read_ms = (time.perf_counter() - t) * 1e3 / 5
    log(f"[deepfm] decode of {DFM_BATCH} records: native {native_decode_ms:.3f} ms, plain "
        f"{plain_decode_ms:.1f} ms (bit for bit equal); bulk read {read_ms:.3f} ms")

    # (a) The card against the CPU on the same weights and batch (its last
    # 128 rows padding), f32 on both, then the bf16 card model.
    spec = deepfm.model_spec(**DFM_WIDTH)
    trainer = Trainer(spec, device="cuda")
    held_bytes = torch.cuda.memory_allocated()  # what earlier phases still hold
    t = time.perf_counter()
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    tree = deepfm.params_to_jax(state.model)
    spec32 = deepfm.model_spec(**DFM_WIDTH, compute_dtype="float32")
    host_batch = dict(native)
    host_batch[MASK_KEY] = (np.arange(DFM_BATCH) < DFM_BATCH - DFM_BATCH // 64).astype(np.float32)
    cpu_model = deepfm.params_from_jax(tree, buckets, 8, "float32", device="cpu")
    cpu_batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host_batch.items()}
    ref_logits, ref_loss, ref_grads = _dfm_loss_and_grads(spec32, cpu_model, cpu_batch)
    card_batch = trainer.shard_batch(host_batch)
    # The upload keeps the wire dtypes: uint16 ids and float16 dense arrive
    # bit for bit.
    for k in ("cat", "dense", "labels"):
        assert card_batch[k].dtype == cpu_batch[k].dtype, k
        assert torch.equal(card_batch[k].cpu().view(torch.uint8), cpu_batch[k].view(torch.uint8)), k
    parity = {}
    for name, model, sp, limit in (
        ("f32", deepfm.params_from_jax(tree, buckets, 8, "float32", device="cuda"), spec32,
         DFM_F32_REL),
        ("bf16", state.model, spec, DFM_BF16_REL),
    ):
        logits, loss, grads = _dfm_loss_and_grads(sp, model, card_batch)
        reading = {"logits": _rel(logits, ref_logits), "loss": abs(float(loss) - float(ref_loss))}
        reading.update({f"grad/{n}": _rel(g, ref_grads[n]) for n, g in grads.items()})
        parity[name] = reading
        worst = max(reading, key=reading.get)
        log(f"[deepfm] card {name} vs CPU f32: logits {reading['logits']:.3g}, loss "
            f"{float(loss):.6f} vs {float(ref_loss):.6f}, fm_table grad "
            f"{reading['grad/fm_table']:.3g}, largest {worst} {reading[worst]:.3g}; limit {limit}")
        assert all(v <= limit for v in reading.values()), reading
    del cpu_model, ref_grads

    # (a) An out-of-range id of either sign reads NaN on the card, without
    # a device assert, and its cotangent is dropped.
    table = state.model.fm_table.detach().clone().requires_grad_(True)
    rows = logical_rows(table, 9)
    ids = torch.tensor([0, -1, rows, -(2**40), 2**40, 5], device="cuda")
    got = gather_rows(table, ids, 9)
    (got * 2.0).sum().backward()
    torch.cuda.synchronize()
    touched = sorted(set(torch.nonzero(table.grad.reshape(-1, 16)[:, :9].abs().sum(1)).flatten().tolist()))
    oob_ok = (bool(torch.isnan(got[1:5]).all()) and bool(torch.isfinite(got[[0, 5]]).all())
              and bool(torch.isfinite(table.grad).all()) and touched == [0, 5])
    log(f"[deepfm] out-of-range ids [-1, {rows}, -2^40, 2^40]: NaN rows, no device assert, "
        f"gradient rows touched {touched}: {oob_ok}")
    assert oob_ok
    del table, got

    # (b) The device step, bench.py's protocol: 5 warm-up steps, then 30
    # measured on one placed batch.
    placed = trainer.shard_batch(dict(native))
    for _ in range(DFM_WARM_STEPS):
        state = trainer.train_step(state, placed)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(DFM_STEPS):
        state, metrics, _ = trainer.train_step(state, placed)
    end.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / DFM_STEPS
    step_event_ms = start.elapsed_time(end) / DFM_STEPS
    peak_bytes = torch.cuda.max_memory_allocated() - held_bytes
    t = time.perf_counter()
    state = trainer.train_step(state, placed)[0]
    enqueue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    holder = [state]

    def one_step():
        holder[0] = trainer.train_step(holder[0], placed)[0]

    breakdown = _dfm_breakdown(one_step)
    state = holder[0]
    log(f"[deepfm] device step ({DFM_STEPS} after {DFM_WARM_STEPS} warm-up, batch {DFM_BATCH}): "
        f"{step_ms:.3f} ms host clock, {step_event_ms:.3f} ms CUDA events, "
        f"{DFM_BATCH / step_ms * 1e3:.0f} examples/s; peak memory {peak_bytes / 2**30:.3f} GiB; "
        f"one step: wall {wall_ms:.3f} ms, host enqueue {enqueue_ms:.3f} ms, device busy "
        f"{breakdown['device_ms']:.3f} ms in {breakdown['kernels']} kernels: "
        + json.dumps(breakdown["groups_ms"]) + f" on {card}")
    log("[deepfm] top kernels: " + json.dumps(breakdown["top_kernels_ms"]))
    log(f"[deepfm] host, profiled: {breakdown['host_ms']:.3f} ms self time; top operators: "
        + json.dumps(breakdown["top_host_ops_ms"]))
    assert np.isfinite(float(metrics["loss"]))

    # The gather and the scatter-add alone at the step's shapes, against
    # their byte bounds: 8192 x 26 ids of 9 f32 values; the gather reads the
    # ids and 36 bytes a row and writes 36; the scatter-add reads the ids
    # and the cotangents and writes the dense table gradient once.
    tbl = state.model.fm_table.detach()
    flat_ids = torch.randint(0, rows, (DFM_BATCH * 26,), device="cuda")
    cot = torch.randn(DFM_BATCH * 26, 9, device="cuda")
    n_ids = flat_ids.numel()
    view = tbl.reshape(-1, 16)

    cot16 = torch.nn.functional.pad(cot, (0, 7))  # the sliced gather's cotangent

    def scatter():  # what autograd runs for index_select's backward
        torch.zeros_like(view).index_add_(0, flat_ids, cot16)

    gather_ms = time_ms(lambda: gather_rows(tbl, flat_ids, 9))
    library_gather_ms = time_ms(lambda: torch.nn.functional.embedding(flat_ids, view)[:, :9])
    scatter_ms = time_ms(scatter)
    gather_bound = bound_ms(n_ids * (8 + 36 + 36), 0, torch.float32)
    scatter_bound = bound_ms(n_ids * (8 + 36) + tbl.numel() * 4, n_ids * 9, torch.float32)
    log(f"[deepfm] gather {gather_ms:.4f} ms (bound {gather_bound[0]:.4f}, "
        f"F.embedding {library_gather_ms:.4f}); scatter-add with the zeroed dense gradient "
        f"{scatter_ms:.4f} ms (bound {scatter_bound[0]:.4f})")

    # (c) End to end, with the ingest pool on auto and at one thread; the
    # second run ends on an eval round (after its last training report, so
    # outside the measured window).
    epochs = (DFM_WARM_TASKS + DFM_MEASURE_TASKS) // DFM_FILE_TASKS
    kernels.reset_counts()
    e2e = {}
    for threads in (0, 1):
        run = _dfm_e2e(spec, train, reader, threads, epochs, val=val if threads else "")
        e2e[threads] = run
        phases = {k: round(v, 4) for k, v in run["phase_times"].items() if v}
        log(f"[deepfm] e2e, ingest_threads {threads} ({run['ingest_threads']} threads): "
            f"{run['examples_per_s']:.0f} examples/s over {run['tasks_measured']} tasks "
            f"({run['examples_measured']} examples, {run['elapsed_s']:.3f} s); wall "
            f"{run['wall_s']:.2f} s, {run['steps']} steps; task losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; phases (s) " + json.dumps(phases))
    log(f"[deepfm] eval round after the {e2e[1]['steps']} steps of {epochs} epochs: "
        + json.dumps(e2e[1]["eval_metrics"]))
    assert not any(kernels.counts().values())  # DeepFM runs no hand-written kernel

    # (d) One eval round, on a file whose last minibatch is a masked tail,
    # at the end of a two-epoch job: the 9-epoch runs above memorise their
    # 131,072 records (the training loss falls toward 0 and the held-out
    # AUC with it), so this round scores a model that has learned the rule.
    run = _dfm_e2e(spec, train, reader, 0, 2, val=val)
    ev = run["eval_metrics"]
    log(f"[deepfm] eval round ({DFM_VAL} records, masked tail of {DFM_VAL % DFM_BATCH}) "
        f"after {run['steps']} steps (2 epochs): " + json.dumps(ev))
    assert run["eval_rounds"] == 1 and ev["auc"] > 0.5, ev
    assert all(np.isfinite(v) for v in ev.values()), ev

    # (e) The CLI: one epoch in a worker process on the card, an eval round
    # and a checkpoint at its end.
    cli = _dfm_cli(train, val, out)
    for path in (train, val):  # 37 MiB of data: made again by each run
        os.remove(path)
    return {
        "config": dict(DFM_WIDTH, batch=DFM_BATCH, compute_dtype="bfloat16",
                       pipeline_preprocess=True, optimizer="adam", learning_rate=1e-3),
        "init_s": init_s, "decode": {"native_ms": native_decode_ms, "plain_ms": plain_decode_ms,
                                     "bulk_read_ms": read_ms},
        "parity": parity, "oob_ok": oob_ok,
        "step": {"ms": step_ms, "event_ms": step_event_ms,
                 "examples_per_s": DFM_BATCH / step_ms * 1e3, "peak_bytes": peak_bytes,
                 "wall_ms": wall_ms, "enqueue_ms": enqueue_ms, "device": breakdown},
        "gather": {"ms": gather_ms, "bound_ms": gather_bound[0], "library_ms": library_gather_ms},
        "scatter_add": {"ms": scatter_ms, "bound_ms": scatter_bound[0]},
        "e2e": {str(k): v for k, v in e2e.items()}, "eval": ev, "cli": cli,
    }


# Phase 11 (a): a world of one over NCCL, in this process, at phase 4's
# width and batch (remat on): GANG_STEPS steps through a Trainer over the
# process group and through a bare Trainer from the same seeded state,
# twice for the bare one (the premise: the step is deterministic on the
# card); then that Trainer's fused dispatch over tasks of GANG_SCAN_T
# steps, GANG_TIMED_TASKS of each path timed in turns.
GANG_STEPS = 8
GANG_SCAN_T = 4
GANG_TIMED_TASKS = 2
# Phase 11 (a)'s DeepFM part: phase 10's width and batch (DFM_WIDTH,
# DFM_BATCH), the table row-sharded over the one-rank group with an
# explicit ragged lookup, tasks of GANG_RAGGED_T steps (the batch's rows
# permuted a step).
GANG_RAGGED_T = 8
# Phase 11 (b): two worker processes on the one card through the CLI's
# local mode, the gloo backend on card tensors, phase 7's files (one epoch:
# 8 tasks of 4 minibatches of 16, 32 steps), a checkpoint every 8 steps,
# eval rounds every 16 steps over the 72 validation records (a masked tail
# of 8, 4 a rank).  Rank 1 stalls at its first task boundary past step 20
# and is SIGKILLed there; rank 0, blocked in that step's collective,
# snapshots and exits 3; both are relaunched and finish from the snapshot.
GANG_JOB = "chip11"
GANG_FLAGS = dict(minibatch_size=16, num_minibatches_per_task=4, num_epochs=1,
                  evaluation_steps=16, checkpoint_steps=8, keep_checkpoint_max=2)
GANG_KILL_STEP = 20
# The gang's losses at its first GANG_LOSS_STEPS steps (the mean over two
# ranks of 8 examples each; every step after the first applies the reduced
# gradient of the one before) against one process's losses on the same
# batches of 16 from the same weights.  Set from the readings on the card
# (NVIDIA H100 80GB HBM3, 700 W: 0, 4.6e-5, 2.9e-5, 4.7e-5, the same in two
# runs) with room for run-to-run spread; the limit must also reject what a
# gang that did not reduce its gradients would read (each rank stepping on
# its own 8: 0, 7.8e-4, 1.1e-2, 2.6e-2 there).
GANG_LOSS_STEPS = 4
GANG_LOSS_ABS = 2e-4
NCCL_PAIR = r"""
import datetime, sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
t = datetime.timedelta(seconds=60)
torch.cuda.set_device(0)
store = dist.TCPStore("127.0.0.1", port, 2, rank == 0, timeout=t)
dist.init_process_group("nccl", store=store, rank=rank, world_size=2, timeout=t,
                        device_id=torch.device("cuda:0"))
x = torch.ones(4, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("NCCL_PAIR_OK", x.tolist(), flush=True)
"""


def _host_arrays(trainer, state) -> dict:
    return {k: np.asarray(v) for k, v in trainer.host_state(state).items()}


def phase_gang_world1(card: str, train_p50_ms: float) -> dict:
    """Phase 11 (a): ``Trainer`` over a one-rank NCCL process group against
    the bare ``Trainer`` at the same width, from the same seeded state on
    the same batches: the states must be equal bit for bit (a sum over one
    rank divided by one is exact).  Step p50 against phase 4's; the
    all-reduce's device time from a profile of one step.  Then the same
    trainer's fused dispatch (``_gang_scan``)."""
    import datetime

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch.data.codecs import encode_lm_example
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    names = (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)
    layers = TRAIN_WIDTH["n_layers"]
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=True, **TRAIN_WIDTH)
    rng = np.random.default_rng(11)
    toks = _planted_sequences(rng, TRAIN_BATCH * (GANG_STEPS + 1), TRAIN_WIDTH["seq_len"],
                              TRAIN_WIDTH["vocab"])
    records = [encode_lm_example(t) for t in toks]
    batches = [spec.feed(records[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(GANG_STEPS + 1)]
    # Deterministic kernels where PyTorch has a choice (the embedding's
    # scatter-add backward): the bit-for-bit comparison needs a step that
    # repeats exactly.
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)

    def timed(host_batches, marks):
        # Step time: host clock between synchronised batch hand-outs.
        for batch in host_batches:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    def bare_run() -> tuple:
        trainer = Trainer(spec, device="cuda")
        state = trainer.init_state(0)
        marks = []
        state, _ = trainer.run_train_steps(state, timed(batches[:GANG_STEPS], marks))
        out = _host_arrays(trainer, state)
        del trainer, state
        torch.cuda.empty_cache()
        return out, [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda:0"),
                            timeout=datetime.timedelta(seconds=60))
    try:
        bare_a, bare_ms = bare_run()
        bare_b, _ = bare_run()
        mesh = create_mesh()
        gang = Trainer(spec, device="cuda", mesh=mesh)
        assert gang._group is not None and dist.get_backend(gang._group) == "nccl"
        state = gang.init_state(0)
        marks = []
        kernels.reset_counts()  # the gang trainer's run starts here
        state, metrics = gang.run_train_steps(state, timed(batches[:GANG_STEPS], marks))
        counts = {n: _count(n) for n in names}  # ... and ends here
        got = _host_arrays(gang, state)
        # One more step under the profiler: the NCCL kernels' device time.
        holder = [state]

        def one_step():
            holder[0] = gang.run_train_step(holder[0], batches[GANG_STEPS])[0]

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one_step()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
        nccl_ms = sum(ms for k, ms in by_kernel.items() if "nccl" in k.lower())
        device_ms = sum(by_kernel.values())
        reduced = sum(p.numel() for p in state.model.parameters()) + len(metrics[0])
        del state, holder
        torch.cuda.empty_cache()
        scan = _gang_scan(gang, batches, card)
        del gang
        torch.cuda.empty_cache()
        ragged = _gang_scan_ragged(card)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    p50, bare_p50 = statistics.median(step_ms), statistics.median(bare_ms)
    same_bare = [k for k in bare_a if not np.array_equal(bare_a[k], bare_b[k])]
    diff = [k for k in bare_a if not np.array_equal(bare_a[k], got[k])]
    log(f"[gang1] NCCL world of 1: {GANG_STEPS} steps at batch {TRAIN_BATCH}, losses "
        + ", ".join(f"{float(m['loss']):.4f}" for m in metrics)
        + f"; {len(got)} arrays, {len(diff)} differ from the bare Trainer's "
        f"({len(same_bare)} differ between two bare runs); step p50 {p50:.2f} ms vs the bare "
        f"Trainer's {bare_p50:.2f} ms here (deterministic kernels) and phase 4's "
        f"{train_p50_ms:.2f} ms; one step: NCCL all-reduce {nccl_ms:.3f} ms of "
        f"{device_ms:.2f} ms device time ({reduced * 4 / 1e6:.1f} MB reduced); launches "
        + json.dumps(counts) + f" on {card}")
    assert not same_bare, f"two bare runs differ in {same_bare[:5]}: the step does not repeat"
    assert not diff, f"the world-1 gang state differs from the bare Trainer's in {diff[:5]}"
    # remat: two forwards a layer a step.
    assert counts == {n: (2 if n == fa.KERNEL else 1) * layers * GANG_STEPS
                      for n in names}, counts
    return {"steps": GANG_STEPS, "step_ms": step_ms, "p50_step_ms": p50,
            "bare_step_ms": bare_ms, "bare_p50_step_ms": bare_p50,
            "phase4_p50_ms": train_p50_ms, "nccl_allreduce_ms": nccl_ms,
            "step_device_ms": device_ms, "reduced_bytes": reduced * 4,
            "losses": [float(m["loss"]) for m in metrics],
            # The per-step run's launches and the scan's replayed task's.
            "launches": {n: counts[n] + scan["launches"][n] for n in names},
            "per_step_launches": counts, "arrays_equal": len(got) - len(diff), "scan": scan,
            "ragged_deepfm": ragged}


def _force_mask(trainer, mask) -> None:
    """Set the contributor mask, the all-zero one included, which
    ``set_active_contributors`` refuses (an empty subgroup has no mean) and
    which is the only other mask of a world of one: the step then weighs
    every example by 0."""
    trainer._active_np = np.asarray(mask, np.float32)
    trainer._write_weight()


def _nccl_kernels(fn) -> dict:
    """The NCCL kernels one ``fn()`` runs on the device (torch.profiler):
    their count, device ms and names, the kernels in all, and the
    device-to-device copies (count and ms), where a one-rank NCCL exchange
    may move its bytes without a kernel of its own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ran = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [(name, us) for name, us in ran if "nccl" in name.lower()]
    dtod = [us for name, us in ran if "DtoD" in name]
    return {"count": len(nccl), "ms": sum(us for _, us in nccl) / 1e3,
            "names": sorted({name[:80] for name, _ in nccl}), "kernels": len(ran),
            "dtod_copies": len(dtod), "dtod_ms": sum(dtod) / 1e3}


def _replay_vs_eager(trainer, state, placed: dict, steps: list, extra=None):
    """A captured task against the same task run eagerly, on ``trainer``
    after ``_fused_checks``: the collective calls by ``"<tag>:<op>"`` that
    one replay adds and one eager task adds (held equal, and equal to the
    graph's recorded calls); the NCCL kernels of one profiled replay, one
    eager task and each of ``extra`` (``{name: fn}``); the step ms of both
    paths in turns (CUDA events, GANG_TIMED_TASKS tasks each, over the
    task's steps).  Returns the state and the readings."""
    red = trainer.reducer
    graph = next(g for g in trainer.scan_graphs() if g["kind"] == "train_scan")
    holder = [state]

    def replay():
        holder[0] = trainer.train_scan(holder[0], placed)[0]

    def eager():
        holder[0] = trainer.run_train_steps(holder[0], steps, pre_sharded=True)[0]

    calls = {}
    for arm, fn in (("replay", replay), ("eager", eager)):
        before = red.calls_by_op
        fn()
        calls[arm] = {k: n - before.get(k, 0) for k, n in red.calls_by_op.items()
                      if n != before.get(k, 0)}
    assert calls["replay"] == calls["eager"] == graph["collectives"], (calls, graph)
    nccl = {"replay": _nccl_kernels(replay), "eager": _nccl_kernels(eager)}
    nccl.update({name: _nccl_kernels(fn) for name, fn in (extra or {}).items()})
    timing = {"per_step": [], "fused": []}
    for _ in range(GANG_TIMED_TASKS):
        for arm, fn in (("per_step", eager), ("fused", replay)):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            timing[arm].append(a.elapsed_time(b) / len(steps))
    step_ms = {arm: statistics.median(v) for arm, v in timing.items()}
    return holder[0], {"calls": calls, "nccl": nccl, "step_ms": step_ms, "timing": timing}


def _gang_scan(gang, batches: list, card: str) -> dict:
    """Phase 11 (a)'s fused half, on the one-rank NCCL ``gang`` trainer (its
    deterministic kernels on): phase 17's checks (``_fused_checks``: a warm
    eager task, the capture, a replay under sync-debug "error" against the
    per-step loop bit for bit with equal launch counts, a restore then a
    fused task, ``eval_scan``); ``_replay_vs_eager`` (a replay's
    collective calls against an eager task's, the NCCL kernels of each,
    the step ms of both); the mask read at replay."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    names = (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)
    layers, t = TRAIN_WIDTH["n_layers"], GANG_SCAN_T
    stacked = {k: np.stack([np.asarray(b[k]) for b in batches[:t]]) for k in batches[0]}
    readings, fused_counts, state, capture_task_s = _fused_checks(gang, stacked)
    assert all(v == 0.0 for v in readings.values()), readings
    assert fused_counts == {n: (2 if n == fa.KERNEL else 1) * layers * t
                            for n in names}, fused_counts
    graph = next(g for g in gang.scan_graphs() if g["kind"] == "train_scan")
    placed = gang.shard_stacked_batch(stacked)
    steps = [{k: v[i] for k, v in placed.items()} for i in range(t)]
    state, vs = _replay_vs_eager(gang, state, placed, steps)
    replay_calls, eager_calls = (sum(vs["calls"][arm].values()) for arm in ("replay", "eager"))
    # A one-rank in-place all-reduce launches no NCCL kernel in either
    # (NCCL returns at once for one rank): the calls captured are the
    # Reducer's tally.
    nccl = vs["nccl"]
    assert replay_calls > 0 and nccl["replay"]["count"] == nccl["eager"]["count"], (vs, graph)

    # The mask read at replay: all-zero between the capture and a replay.
    start = gang.host_state(state)
    _force_mask(gang, [0.0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, zero = gang.train_scan(state, placed)  # the graph captured under all-ones
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _force_mask(gang, [1.0])
    zero_state = gang.host_state(state)
    state = gang.adopt_restored(start, state)
    _force_mask(gang, [0.0])
    state, per_step = gang.run_train_steps(state, steps, pre_sharded=True)
    _force_mask(gang, [1.0])
    mask_readings = {
        "zero_replay_vs_loop_state": _fused_diff(zero_state, gang.host_state(state)),
        "zero_replay_vs_loop_losses": _fused_diff(
            {"loss": zero["loss"].float().cpu().numpy()},
            {"loss": torch.stack([m["loss"] for m in per_step]).float().cpu().numpy()}),
    }
    state = gang.adopt_restored(start, state)
    state, ones = gang.train_scan(state, placed)  # captured anew, all-ones
    ones_state = gang.host_state(state)
    differ = [k for k in ones_state if k.startswith("params/")
              and not np.array_equal(ones_state[k], zero_state[k])]
    zero_loss = float(zero["loss"].abs().sum())
    assert all(v == 0.0 for v in mask_readings.values()), mask_readings
    assert zero_loss == 0.0 and differ, (zero_loss, len(differ))
    del start, zero_state, ones_state

    step_ms, timing = vs["step_ms"], vs["timing"]
    graphs = gang.scan_graphs()
    log(f"[gang1] fused over NCCL, T={t}: replay = per-step loop bit for bit "
        + json.dumps(readings) + f"; launches a task {json.dumps(fused_counts)} on both paths; "
        f"{replay_calls} collective calls a replayed task, {eager_calls} an eager one; NCCL "
        f"kernels, replay and eager task {json.dumps(nccl)}; mask all-zero at replay: equal to the "
        f"eager loop under it {json.dumps(mask_readings)}, {len(differ)} parameters differ "
        f"from the all-ones replay; step ms per step {step_ms['per_step']:.3f}, fused "
        f"{step_ms['fused']:.3f} ({timing}); capture {graph['capture_s']:.2f} s (the task "
        f"that captured {capture_task_s:.2f} s), graph pools "
        + json.dumps({g["kind"]: g["pool_bytes"] for g in graphs}) + f" bytes; on {card}")
    del state
    return {"t": t, "readings": readings, "mask_readings": mask_readings,
            "launches": fused_counts, "replay_collective_calls": replay_calls,
            "eager_collective_calls": eager_calls, "collectives": graph["collectives"],
            "nccl_kernels": nccl, "params_differ_zero_vs_ones": len(differ),
            "step_ms": step_ms, "step_ms_all": timing, "capture_s": graph["capture_s"],
            "capture_task_s": capture_task_s,
            "graphs": [{k: g[k] for k in ("kind", "capture_s", "pool_bytes")} for g in graphs]}


def _gang_scan_ragged(card: str) -> dict:
    """Phase 11 (a)'s DeepFM part, in the one-rank NCCL world of the phase
    (its deterministic kernels on): DeepFM at phase 10's width under the
    ParameterServer strategy with an explicit ``ragged`` lookup, so the
    route's equal-split all-to-alls run over the group.  Phase 17's checks
    (``_fused_checks``) on a task of GANG_RAGGED_T steps;
    ``_replay_vs_eager``, with the NCCL kernels and device copies of one
    lookup forward alone besides; a replay's calls hold the route's 3 a
    step and no all-gather."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import RecordIODataReader
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ops.embedding import embedding_lookup
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    t_part, t = time.perf_counter(), GANG_RAGGED_T
    spec = deepfm.model_spec(**DFM_WIDTH)
    path = synthetic_criteo(os.path.join(REPO, "chiprun_out", "gang1_criteo.rio"), DFM_BATCH,
                            seed=13, container="recordio")
    reader = RecordIODataReader(path)
    batch = dict(spec.feed(reader.read_records_packed(reader.create_shards(DFM_BATCH)[0])))
    os.remove(path)
    rng = np.random.default_rng(17)
    perms = [rng.permutation(DFM_BATCH) for _ in range(t)]
    stacked = {k: np.stack([np.asarray(v)[p] for p in perms]) for k, v in batch.items()}
    trainer = Trainer(spec, device="cuda", mesh=create_mesh(), config=JobConfig(
        distribution_strategy="ParameterServer", embedding_lookup_impl="ragged"))
    ctx = trainer.ctx
    assert (trainer.sharded_embeddings and ctx.embedding_impl == "ragged"
            and ctx.axis_size == 1 and ctx.group is not None and trainer._scan_captures())
    assert trainer.scan_unsupported() is None
    readings, fused_counts, state, capture_task_s = _fused_checks(trainer, stacked)
    assert all(v == 0.0 for v in readings.values()), readings
    graph = next(g for g in trainer.scan_graphs() if g["kind"] == "train_scan")
    placed = trainer.shard_stacked_batch(stacked)
    steps = [{k: v[i] for k, v in placed.items()} for i in range(t)]

    # One eager forward of the lookup alone, at the step's shape: its two
    # exchanges are the only copies in it, so its reading is what a
    # one-rank NCCL all-to-all runs on the device.
    table = state.model.fm_table.detach()
    ids = torch.randint(0, 26 * DFM_WIDTH["buckets_per_feature"], (DFM_BATCH, 26),
                        device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))

    def lookup():
        embedding_lookup(table, ids, ctx, dim=DFM_WIDTH["embedding_dim"] + 1)

    state, vs = _replay_vs_eager(trainer, state, placed, steps, {"lookup_forward": lookup})
    del table, ids
    replay_calls, eager_calls = vs["calls"]["replay"], vs["calls"]["eager"]
    # Reported, not held: the NCCL kernels and device copies.
    nccl, step_ms, timing = vs["nccl"], vs["step_ms"], vs["timing"]
    assert replay_calls.get("lookup:all_to_all") == 3 * t, replay_calls
    assert "lookup:all_gather" not in replay_calls, replay_calls
    pools = {g["kind"]: g["pool_bytes"] for g in trainer.scan_graphs()}
    wall_s = time.perf_counter() - t_part
    log(f"[gang1] DeepFM B={DFM_BATCH}, table row-sharded over the NCCL world of 1, explicit "
        f"ragged lookup, T={t}: replay = per-step loop bit for bit " + json.dumps(readings)
        + f"; calls a replayed task {json.dumps(replay_calls)}, an eager one "
        f"{json.dumps(eager_calls)}; NCCL kernels, replay and eager task {json.dumps(nccl)}; "
        f"step ms per step {step_ms['per_step']:.3f}, fused {step_ms['fused']:.3f} ({timing}); "
        f"capture {graph['capture_s']:.2f} s (the task that captured {capture_task_s:.2f} s), "
        f"graph pools {json.dumps(pools)} bytes; {wall_s:.1f} s on {card}")
    del trainer, state, placed, steps
    torch.cuda.empty_cache()
    return {"t": t, "batch": DFM_BATCH, "readings": readings, "launches": fused_counts,
            "replay_calls": replay_calls, "eager_calls": eager_calls,
            "collectives": graph["collectives"], "nccl_kernels": nccl, "step_ms": step_ms,
            "step_ms_all": timing, "capture_s": graph["capture_s"],
            "capture_task_s": capture_task_s, "pool_bytes": pools, "wall_s": wall_s}


def _nccl_pair_on_one_card() -> str:
    """Two NCCL ranks on one card: what the installed NCCL says (it is
    expected to refuse)."""
    port = _free_port()
    outs = [os.path.join(REPO, "chiprun_out", f"nccl_pair_{r}.log") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PAIR, str(r), str(port)],
                              stdout=open(o, "w"), stderr=subprocess.STDOUT)
             for r, o in zip((0, 1), outs)]
    for p in procs:
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    text = "\n".join(_read(o) for o in outs)
    if "NCCL_PAIR_OK" in text:
        return "accepted: " + next(x for x in text.splitlines() if "NCCL_PAIR_OK" in x)
    lines = [x.strip() for x in text.splitlines()
             if "Error" in x or "error" in x or "Duplicate" in x or "invalid" in x.lower()]
    return "refused (rcs %s): %s" % ([p.returncode for p in procs], " | ".join(lines[-3:])[:600])


def _assert_fused_gang(logs: dict) -> None:
    """Every gang worker's log says its tasks ran as one ``train_scan`` each,
    the steps eagerly (gloo)."""
    for name, text in logs.items():
        if text:
            assert "task dispatch: fused" in text, f"{name} did not take the fused path"
            assert "scans: the steps eagerly" in text, f"{name}'s scans did not run eagerly"


def phase_gang_pair(card: str) -> dict:
    """Phase 11 (b): two worker processes on the one card through the CLI's
    local mode (``--multihost --dcn_data_parallelism=2``, gloo on card
    tensors), each rank 8 of the 16 examples at phase 4's width.  Rank 1 is
    SIGKILLed at a task boundary past step ``GANG_KILL_STEP``; rank 0 (its
    collective fails) snapshots and exits 3; the pod manager relaunches
    both; the gang re-forms and finishes from the snapshot.  Both ranks'
    states are equal at every checkpoint (digests), the losses of the
    first steps match one process on the same batches, every task is done
    once and no step twice."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    nccl_pair = _nccl_pair_on_one_card()
    log(f"[gang2] two NCCL ranks on one card: {nccl_pair}")
    out = os.path.join(REPO, "chiprun_out", "job")
    train, val = os.path.join(out, "train.rio"), os.path.join(out, "val.rio")
    assert os.path.exists(train) and os.path.exists(val), "phase 7 writes the job's data"
    ckpt, pods = os.path.join(out, "ckpt11"), os.path.join(out, "pods11")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(pods, ignore_errors=True)
    width, mb = TRAIN_WIDTH, GANG_FLAGS["minibatch_size"]
    layers = width["n_layers"]
    per_task = mb * GANG_FLAGS["num_minibatches_per_task"]
    n_tasks = JOB_TRAIN // per_task
    w0, w1 = f"{GANG_JOB}-worker-0", f"{GANG_JOB}-worker-1"
    w0b, w1b = f"{w0}-r1", f"{w1}-r1"
    pod_log = {n: os.path.join(pods, f"{n}.log") for n in (w0, w1, w0b, w1b)}
    params = ";".join(f"{k}={v}" for k, v in width.items())
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={GANG_JOB}", "--model_def=transformer_lm.model_spec",
           f"--model_params={params};compute_dtype=bfloat16;remat=false",
           "--learning_rate=3e-4", f"--training_data={train}", f"--validation_data={val}",
           f"--checkpoint_dir={ckpt}", f"--pod_log_dir={pods}", "--max_worker_relaunch=2",
           "--num_workers=2", "--multihost=true", "--dcn_data_parallelism=2",
           f"--coordinator_port={_free_port()}",
           f"--chaos=stall:worker={w1},point=task,step={GANG_KILL_STEP},ms=600000"]
    cmd += [f"--{k}={v}" for k, v in GANG_FLAGS.items()]
    torch.cuda.empty_cache()  # the worker processes share the card with this one
    os.environ["ELASTICDL_TORCH_DIST_BACKEND"] = "gloo"
    os.environ["ELASTICDL_STATE_DIGEST"] = "1"
    cli_path = os.path.join(out, "cli11.log")
    t0 = time.time()
    try:
        proc = _start_cli(cmd, cli_path)
    finally:
        del os.environ["ELASTICDL_TORCH_DIST_BACKEND"], os.environ["ELASTICDL_STATE_DIGEST"]
    try:
        _wait_for(lambda: "[graftchaos] stall" in _read(pod_log[w1]),
                  f"rank 1's boundary past step {GANG_KILL_STEP}", proc, timeout_s=600)
        time.sleep(1.0)  # rank 0 enters the step's collective and blocks there
        t_kill = time.time()
        os.kill(_worker_events(_read(pod_log[w1]))["ready"]["pid"], signal.SIGKILL)
        rc = proc.wait(timeout=600)
        wall_s = time.time() - t0
    finally:
        _stop_cli(proc)
    cli, logs = _read(cli_path), {n: _read(p) for n, p in pod_log.items()}
    assert rc == 0, f"the job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    ev = {n: _worker_events(text) for n, text in logs.items()}
    digests = {n: {} for n in logs}
    for n, text in logs.items():
        for line in text.splitlines():
            if line.startswith("[worker-event] "):
                e = json.loads(line[len("[worker-event] "):])
                if e["event"] == "checkpoint":
                    digests[n][e["step"]] = e["digest"]

    # The job: every task done once; the exit codes; the worlds formed.
    _assert_fused_gang(logs)
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0, status
    assert np.isfinite(status["eval_metrics"]["loss"]), status
    for needle in (f"pod {w1} exited rc=-9 -> Failed", f"pod {w0} exited rc=3 -> Restart",
                   f"relaunching failed pod {w1} as {w1b}", f"relaunching failed pod {w0} as {w0b}",
                   f"pod {w0b} exited rc=0 -> Succeeded", f"pod {w1b} exited rc=0 -> Succeeded"):
        assert needle in cli, needle
    for n in (w0, w1, w0b, w1b):
        assert ev[n]["gang"]["world"] == 2 and ev[n]["gang"]["mesh"] == {"dp": 2, "ep": 1}, ev[n]
    assert ev[w0]["gang"]["rank"] == 0, ev[w0]["gang"]  # the reporter survives and saves
    snap = int(logs[w0].split("pre-restart snapshot at step ", 1)[1].split()[0])
    assert ev[w0b]["ready"]["joined_step"] == snap == ev[w1b]["ready"]["joined_step"], (
        snap, ev[w0b]["ready"], ev[w1b]["ready"])
    # Identical states: every checkpoint both ranks of a world passed.
    for a, b in ((w0, w1), (w0b, w1b)):
        shared = sorted(set(digests[a]) & set(digests[b]))
        assert shared and all(digests[a][k] == digests[b][k] for k in shared), (
            a, digests[a], b, digests[b])
    # Lockstep: both ranks of the relaunched world ran the same tasks.
    sa, sb = ev[w0b]["summary"], ev[w1b]["summary"]
    assert sa["tasks"] == sb["tasks"] and sa["step"] == sb["step"], (sa["tasks"], sb["tasks"])
    # No step trained twice: the snapshot holds the reported tasks only, so
    # the job ends at the epoch's step count.
    manifest = read_manifest(ckpt)
    epoch_steps = n_tasks * GANG_FLAGS["num_minibatches_per_task"]
    assert manifest["step"] == sa["step"] == epoch_steps, (manifest, sa["step"], epoch_steps)
    for summary in (sa, sb):
        _check_job_launches(summary["launches"], layers, summary["steps"], summary["eval_steps"])

    # The first steps against one process on the same batches of 16 (the
    # first task's minibatches: the dispatcher hands out the shards in
    # order), from the same seeded weights.
    reader = create_data_reader(train)
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **width)
    single = Trainer(spec, device="cuda")
    batches = [spec.feed(list(reader.read_records(shard)))
               for shard in reader.create_shards(mb)[:GANG_LOSS_STEPS]]
    _, ms = single.run_train_steps(single.init_state(0), batches)
    single_losses = [float(m["loss"]) for m in ms]
    del single, ms
    torch.cuda.empty_cache()
    halves = []
    for half in (slice(0, mb // 2), slice(mb // 2, mb)):
        alone = Trainer(spec, device="cuda")
        _, ms = alone.run_train_steps(alone.init_state(0),
                                      [{k: v[half] for k, v in b.items()} for b in batches])
        halves.append([float(m["loss"]) for m in ms])
        del alone, ms
        torch.cuda.empty_cache()
    unreduced_diffs = [abs((a + b) / 2 - c) for a, b, c in zip(*halves, single_losses)]
    gang_losses = ev[w0]["first_steps"]["losses"]
    assert ev[w1]["first_steps"]["losses"] == gang_losses, (ev[w0]["first_steps"],
                                                          ev[w1]["first_steps"])
    gang_loss, single_loss = gang_losses[0], single_losses[0]
    loss_diffs = [abs(a - b) for a, b in zip(gang_losses, single_losses)]
    log(f"[gang2] losses of the first {GANG_LOSS_STEPS} steps: gang "
        + ", ".join(f"{x:.6f}" for x in gang_losses) + " (two ranks of 8) vs one process "
        + ", ".join(f"{x:.6f}" for x in single_losses) + " (16); |diff| "
        + ", ".join(f"{x:.2e}" for x in loss_diffs) + f", limit {GANG_LOSS_ABS}; a gang "
        "without the gradient reduction would read |diff| "
        + ", ".join(f"{x:.2e}" for x in unreduced_diffs))
    assert len(gang_losses) == GANG_LOSS_STEPS and max(loss_diffs) <= GANG_LOSS_ABS
    assert max(unreduced_diffs) > GANG_LOSS_ABS, "the limit cannot see an unreduced gradient"

    # Times.  The re-form, from the SIGKILL to the re-formed gang's first
    # step, split at what each process logged.
    detect_at = _log_time(logs[w0], "collective failed in lockstep mode")
    exit_at = _log_time(cli, f"pod {w0} exited")
    start = max(ev[w0b]["ready"]["started_at"], ev[w1b]["ready"]["started_at"])
    gang0 = ev[w0b]["gang"]
    reform = {
        "detect_s": detect_at - t_kill,
        "exit3_s": exit_at - detect_at,
        "relaunch_boot_s": start + ev[w0b]["ready"]["boot_s"] - exit_at,
        "settle_s": gang0["settle_s"],
        "init_process_group_s": gang0["init_process_group_s"],
        "restore_s": ev[w0b]["ready"]["restore_s"],
        "first_step_s": ev[w0b]["first_step"]["at"] - t_kill,
    }
    saves = [line for line in logs[w0].splitlines() + logs[w0b].splitlines()
             if "checkpoint step " in line and " saved: " in line]
    snap_line = next((x for x in saves if f"checkpoint step {snap} saved" in x), None)
    step_ms = sa["step_ms"]
    p50 = statistics.median(step_ms)
    # The all-reduce a training step waits for, on average, over its p50.
    train_collective_s = sa["collective_s"] - sa["eval_collective_s"]
    share = train_collective_s / max(sa["steps"], 1) / max(p50 / 1e3, 1e-9)
    log(f"[gang2] {status['done']} tasks done ({n_tasks} a epoch), {status['abandoned']} "
        f"abandoned, {status['duplicate_done']} duplicates, eval loss "
        f"{status['eval_metrics']['loss']:.4f}; SIGKILL of rank 1 -> rank 0 snapshot at {snap}, "
        f"exit 3 -> both relaunched, joined from {snap}, final step {manifest['step']}; "
        f"digests equal at steps {sorted(set(digests[w0]) & set(digests[w1]))} and "
        f"{sorted(set(digests[w0b]) & set(digests[w1b]))}")
    log(f"[gang2] gang step p50 {p50:.2f} ms (device events, rank 0 of the relaunched "
        f"world, {len(step_ms)} intervals); collectives {sa['collective_s']:.2f} s over "
        f"{sa['collective_calls']} calls, {train_collective_s:.2f} s of it in {sa['steps']} "
        f"train steps: the all-reduce is {share:.1%} of the step p50; snapshot: "
        f"{snap_line.split('] ', 3)[-1] if snap_line else 'periodic step already on disk'}; "
        f"on {card}")
    log("[gang2] re-form after SIGKILL (s): " + ", ".join(f"{k} {v:.3f}" for k, v in reform.items())
        + f"; job wall {wall_s:.2f}s; on {card}")
    log("[gang2] saves: " + " | ".join(x.split("] ", 3)[-1] for x in saves))
    shutil.rmtree(ckpt)  # 1.33 GB a checkpoint: too much to keep in chiprun_out/
    launches = {n: sa["launches"].get(n, 0) + sb["launches"].get(n, 0)
                for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}
    return {
        "nccl_pair": nccl_pair, "status": {k: status[k] for k in (
            "done", "abandoned", "duplicate_done", "eval_rounds", "eval_metrics")},
        "snapshot_step": snap, "final_step": manifest["step"], "reform": reform,
        "first_step_loss": {"gang": gang_loss, "single": single_loss},
        "first_losses": {"gang": gang_losses, "single": single_losses, "abs_diff": loss_diffs,
                         "unreduced_abs_diff": unreduced_diffs},
        "p50_step_ms": p50, "step_ms": step_ms, "collective_s": sa["collective_s"],
        "train_collective_s": train_collective_s,
        "allreduce_share": share, "wall_s": wall_s, "saves": saves,
        "digests": {n: digests[n] for n in digests}, "kernels": launches,
    }


# Phase 12: the ParameterServer strategy across ranks and the sharded
# optimizer, two ranks on the one card over gloo (NCCL refuses two ranks on
# one device, phase 11).
#
# (a) DeepFM at phase 10's width under --distribution_strategy=ParameterServer
# on the flat {dp: 2} mesh (the table on dp itself, half of its rows a
# rank): a spawned world probes every new collective on card tensors and
# trains the first PS_LOSS_STEPS batches of 8192 per route, and the same
# with the table gradient dropped, summed again over the table axis (the
# psum trap) and doubled; then one CLI job per route through the local mode
# (batch 8192, 4096 a rank, tasks of 4 minibatches, a checkpoint every 8
# steps), rank 1 SIGKILLed at the first task boundary past step
# PS_KILL_STEP in the ragged one.
PS_JOB = "chip12"
PS_BATCH, PS_MB_PER_TASK, PS_EPOCH_STEPS = 8192, 4, 16
PS_CKPT_STEPS, PS_KILL_STEP = 8, 20
PS_LOSS_STEPS = 4
# The two-rank gang's losses at its first PS_LOSS_STEPS steps against one
# process's replicated Trainer on the same batches of 8192 from the same
# weights (bf16 GEMMs over 4096 rows a rank against 8192, the gradient sums
# in another order).  Set from the readings on the card (NVIDIA H100 80GB
# HBM3, 700 W; both routes alike: 0, 7.2e-6, 3.0e-6, 2.2e-5) with room on
# both sides: the limit must reject a gang whose table gradient is dropped
# (0, 3.0e-4, 3.5e-4, 3.4e-4 there) or summed again over the table axis
# (0, 1.5e-4, 2.7e-4, 3.3e-4).  A doubled table gradient reads within the
# gang's own spread (0, 3.3e-6, 6.5e-6, 2.1e-5): Adam divides each
# element's step by its gradient's running scale, so a constant factor
# only moves the steps of elements whose gradient is near Adam's eps.
PS_LOSS_ABS = 1e-4
# (b) transformer_lm at phase 4's width, (dp=2, ep=1),
# --optimizer_sharding=sharded, batch 8 a rank, OPT_STEPS steps; the losses
# against one process at batch 16 within GANG_LOSS_ABS.
OPT_STEPS, OPT_BATCH = 4, 8


def _rank_entry(rank, world, port, fn, args, out):
    """One spawned rank on the card: a gloo world over ``port``, then
    ``fn(rank, world, *args)``; the result or the traceback to ``out``."""
    import traceback

    os.environ["ELASTICDL_TORCH_DIST_BACKEND"] = "gloo"
    try:
        from elasticdl_tpu_torch.common.device import set_matmul_precision
        from elasticdl_tpu_torch.parallel import distributed

        set_matmul_precision()
        torch.cuda.set_device(0)
        spec = distributed.DistributedSpec(f"127.0.0.1:{port}", world, rank,
                                           heartbeat_timeout_s=300.0)
        distributed.initialize(spec, torch.device("cuda", 0))
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            distributed.shutdown()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def _spawn_ranks(fn, world: int, *args, timeout_s: float = 600.0) -> list:
    """``fn`` in a spawned world of ``world`` processes on the card; the
    results in rank order.  Every process is joined (or killed) here."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, port, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout_s)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    except queue.Empty:
        raise AssertionError(f"the spawned world of {world} did not finish in {timeout_s:.0f}s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _probe_collectives(mesh) -> dict:
    """Each collective of the sharded state once on card tensors through
    the ``Reducer`` (so a refusal names its op): ``ok`` or the error."""
    from elasticdl_tpu_torch.parallel import collectives as coll

    red, group, rank = coll.Reducer(mesh), mesh.group(("dp",)), mesh.rank
    n = mesh.size
    probes = {
        "all_reduce": lambda: red.all_reduce(torch.ones(4, device="cuda"), group).sum() == 4 * n,
        "all_gather": lambda: torch.equal(
            red.all_gather(torch.full((3,), rank, device="cuda", dtype=torch.int64), group).cpu(),
            torch.arange(n).repeat_interleave(3)),
        "reduce_scatter": lambda: torch.equal(
            red.reduce_scatter(torch.arange(2.0 * n, device="cuda"), group).cpu(),
            n * torch.arange(2.0 * n).view(n, 2)[rank]),
        # Equal splits, as the ragged lookup sends: rank r's chunk j holds
        # 10 r + j, so chunk j of what it receives holds 10 j + r.
        "all_to_all": lambda: torch.equal(
            red.all_to_all(torch.empty(2 * n, 2, device="cuda"),
                           (10.0 * rank + torch.arange(n, device="cuda")).repeat_interleave(2)
                           [:, None].expand(2 * n, 2).contiguous(), group)[:, 0].cpu(),
            (10.0 * torch.arange(n) + rank).repeat_interleave(2)),
    }
    out = {}
    for name, fn in probes.items():
        try:
            out[name] = "ok" if bool(fn()) else "wrong result"
        except Exception as e:  # reported by the caller, which fails the phase
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def _ps_loss_rank(rank, world, batches, routes):
    """Phase 12 (a)'s spawned world: the collectives probe, then per route
    the first steps' losses of the gang and of three wrong versions."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    mesh = create_mesh()
    out = {"probe": _probe_collectives(mesh)}
    if any(v != "ok" for v in out["probe"].values()):
        return out
    spec = deepfm.model_spec(**DFM_WIDTH)
    for route in routes:
        for variant in ("gang", "dropped", "summed", "doubled"):
            trainer = Trainer(spec, device="cuda", mesh=mesh, config=JobConfig(
                distribution_strategy="ParameterServer", embedding_lookup_impl=route))
            state = trainer.init_state(0)
            if variant == "dropped":
                state.model.fm_table.register_hook(lambda g: g * 0)
            elif variant == "doubled":
                state.model.fm_table.register_hook(lambda g: g * 2)
            elif variant == "summed":
                trainer._table_grad_axes = trainer.reduce_axes
            losses = []
            for batch in batches:
                state, m = trainer.run_train_step(state, batch)
                losses.append(float(m["loss"]))
            out[(route, variant)] = losses
            if variant == "gang":
                out[(route, "rows")] = int(state.model.fm_table.shape[0])
                out[(route, "impl")] = trainer.ctx.embedding_impl
                # The lookup's collective ms a step (the first step's setup in).
                red = trainer.reducer
                out[(route, "lookup_ms")] = {
                    k.split(":", 1)[1]: red.by_op[k] * 1e3 / len(batches)
                    for k in red.by_op if k.startswith("lookup:")}
                out[(route, "lookup_calls")] = {
                    k.split(":", 1)[1]: n for k, n in red.calls_by_op.items()
                    if k.startswith("lookup:")}
            del trainer, state
            torch.cuda.empty_cache()
    return out


def _ps_job(card: str, route: str, train: str, out: str, epochs: int, kill: bool) -> dict:
    """One CLI job of phase 12 (a): DeepFM under ParameterServer on two
    worker processes of the card; with ``kill``, rank 1 SIGKILLed at the
    first task boundary past ``PS_KILL_STEP``.  Checks the job and returns
    its readings."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest

    job = f"{PS_JOB}{route[0]}"
    ckpt, pods = os.path.join(out, f"ckpt_{route}"), os.path.join(out, f"pods_{route}")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(pods, ignore_errors=True)
    w0, w1 = f"{job}-worker-0", f"{job}-worker-1"
    pod_log = {n: os.path.join(pods, f"{n}.log") for n in (w0, w1, f"{w0}-r1", f"{w1}-r1")}
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={job}", "--model_def=deepfm.model_spec", "--learning_rate=1e-3",
           "--model_params=" + ";".join(
               f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
               for k, v in DFM_WIDTH.items()),
           f"--training_data={train}", f"--minibatch_size={PS_BATCH}",
           f"--num_minibatches_per_task={PS_MB_PER_TASK}", f"--num_epochs={epochs}",
           f"--checkpoint_steps={PS_CKPT_STEPS}", "--keep_checkpoint_max=2",
           f"--checkpoint_dir={ckpt}", f"--pod_log_dir={pods}", "--max_worker_relaunch=2",
           "--num_workers=2", "--multihost=true", "--dcn_data_parallelism=1",
           "--distribution_strategy=ParameterServer", f"--embedding_lookup_impl={route}",
           f"--coordinator_port={_free_port()}"]
    if kill:
        cmd.append(f"--chaos=stall:worker={w1},point=task,step={PS_KILL_STEP},ms=600000")
    torch.cuda.empty_cache()
    os.environ["ELASTICDL_TORCH_DIST_BACKEND"] = "gloo"
    os.environ["ELASTICDL_STATE_DIGEST"] = "1"
    cli_path = os.path.join(out, f"cli_{route}.log")
    t0 = time.time()
    try:
        proc = _start_cli(cmd, cli_path)
    finally:
        del os.environ["ELASTICDL_TORCH_DIST_BACKEND"], os.environ["ELASTICDL_STATE_DIGEST"]
    try:
        if kill:
            _wait_for(lambda: "[graftchaos] stall" in _read(pod_log[w1]),
                      f"rank 1's boundary past step {PS_KILL_STEP}", proc, timeout_s=400)
            time.sleep(1.0)  # rank 0 enters the step's lookup and blocks there
            t_kill = time.time()
            os.kill(_worker_events(_read(pod_log[w1]))["ready"]["pid"], signal.SIGKILL)
        rc = proc.wait(timeout=400)
        wall_s = time.time() - t0
    finally:
        _stop_cli(proc)
    cli, logs = _read(cli_path), {n: _read(p) for n, p in pod_log.items()}
    assert rc == 0, f"the {route} job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    ev = {n: _worker_events(text) for n, text in logs.items() if text}
    digests = {n: {} for n in ev}
    for n in ev:
        for line in logs[n].splitlines():
            if line.startswith("[worker-event] "):
                e = json.loads(line[len("[worker-event] "):])
                if e["event"] == "checkpoint":
                    digests[n][e["step"]] = e["digest"]
    n_tasks = epochs * PS_EPOCH_STEPS // PS_MB_PER_TASK
    _assert_fused_gang(logs)
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0, status
    for n in (w0, w1):
        gang = ev[n]["gang"]
        assert gang["world"] == 2 and gang["mesh"] == {"dp": 2}, gang
        assert gang["distribution_strategy"] == "ParameterServer" and gang["sharded_embeddings"]
        assert gang["embedding_lookup_impl"] == route, gang
    last = (f"{w0}-r1", f"{w1}-r1") if kill else (w0, w1)
    sa, sb = ev[last[0]]["summary"], ev[last[1]]["summary"]
    assert sa["tasks"] == sb["tasks"] and sa["step"] == sb["step"]
    manifest = read_manifest(ckpt)
    result = {"wall_s": wall_s, "status": {k: status[k] for k in (
        "done", "abandoned", "duplicate_done")}, "final_step": manifest["step"]}
    if kill:
        for needle in (f"pod {w1} exited rc=-9 -> Failed", f"pod {w0} exited rc=3 -> Restart",
                       f"pod {w0}-r1 exited rc=0 -> Succeeded",
                       f"pod {w1}-r1 exited rc=0 -> Succeeded"):
            assert needle in cli, needle
        # No survivor's snapshot with sharded state: both relaunches join from
        # the periodic checkpoint; the tasks the master counted since it are
        # not trained again, so the job ends at that checkpoint's step plus
        # the steps of the tasks it had not counted.
        assert "pre-restart snapshot at step" not in logs[w0]
        no_snap = next(x for x in logs[w0].splitlines() if "no pre-restart snapshot" in x)
        joined = {ev[n]["ready"]["joined_step"] for n in last}
        assert len(joined) == 1, joined
        resumed = joined.pop()
        counted = logs[w0].count("accepted=True")
        want = resumed + (n_tasks - counted) * PS_MB_PER_TASK
        assert manifest["step"] == sa["step"] == want, (manifest["step"], sa["step"], want)
        assert sa["steps"] == (n_tasks - counted) * PS_MB_PER_TASK, (sa["steps"], counted)
        reform = {
            "detect_s": _log_time(logs[w0], "collective failed in lockstep mode") - t_kill,
            "exit3_s": _log_time(cli, f"pod {w0} exited") - t_kill,
            "restore_s": ev[f"{w0}-r1"]["ready"]["restore_s"],
            "first_step_s": ev[f"{w0}-r1"]["first_step"]["at"] - t_kill,
        }
        result.update(resumed_step=resumed, counted_before_kill=counted, reform=reform,
                      no_snapshot_line=no_snap.split("] ", 3)[-1])
        log(f"[ps] {route} job: SIGKILL of rank 1 at its boundary past step {PS_KILL_STEP}; "
            f"{no_snap.split('] ', 3)[-1]}; both relaunches joined from {resumed}; the old "
            f"world's rank 0 had {counted} tasks counted; final step {manifest['step']} = "
            f"{resumed} + {n_tasks - counted} tasks x {PS_MB_PER_TASK} (no task trained twice); "
            "re-form (s): " + ", ".join(f"{k} {v:.3f}" for k, v in reform.items()))
    else:
        assert manifest["step"] == sa["step"] == n_tasks * PS_MB_PER_TASK, manifest
    # One gathered state in each world: equal digests at every checkpoint.
    for a, b in ((w0, w1),) + ((last,) if kill else ()):
        shared = sorted(set(digests[a]) & set(digests[b]))
        assert shared and all(digests[a][k] == digests[b][k] for k in shared), (
            a, digests[a], b, digests[b])
    per_rank = {}
    for n in last:
        s = ev[n]["summary"]
        steps = max(s["steps"], 1)
        lookup_ms = {k.split(":", 1)[1]: v * 1e3 / steps
                     for k, v in s["collective_by_op"].items() if k.startswith("lookup:")}
        grads_ms = sum(v for k, v in s["collective_by_op"].items()
                       if k.startswith("grads:")) * 1e3 / steps
        snap_s = sum(v for k, v in s["collective_by_op"].items() if k.startswith("snapshot:"))
        per_rank[n] = {"p50_step_ms": statistics.median(s["step_ms"]) if s["step_ms"] else float("nan"),
                       "lookup_ms_per_step": lookup_ms, "grads_ms_per_step": grads_ms,
                       "snapshot_gather_s": snap_s, "state_bytes": s["state_bytes"],
                       "steps": s["steps"]}
        sb_ = s["state_bytes"]
        log(f"[ps] {route} {n}: step p50 {per_rank[n]['p50_step_ms']:.2f} ms over {s['steps']} "
            f"steps; lookup collectives a step (ms) " + json.dumps(
                {k: round(v, 3) for k, v in lookup_ms.items()})
            + f", gradient all-reduce {grads_ms:.3f} ms; snapshot gathers {snap_s:.2f} s; "
            f"table {sb_['tables'] / 1e6:.2f} MB, optimizer {sb_['opt'] / 1e6:.2f} MB, peak "
            f"{sb_.get('max_memory_allocated', 0) / 2**30:.2f} GiB on the card; on {card}")
    result.update(per_rank=per_rank, first_losses=ev[w0]["first_steps"]["losses"],
                  first_losses_rank1=ev[w1]["first_steps"]["losses"], ckpt=ckpt,
                  final_digest=digests[last[0]].get(manifest["step"]))
    return result


def phase_ps(card: str) -> dict:
    """Phase 12 (a): DeepFM under the ParameterServer strategy on two ranks
    of the card (module docstring)."""
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.data.reader import create_data_reader
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ops.embedding import table_bytes
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.worker.main import _state_digest

    out = os.path.join(REPO, "chiprun_out", "ps")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t = time.perf_counter()
    train = synthetic_criteo(os.path.join(out, "train.rio"), PS_EPOCH_STEPS * PS_BATCH,
                             seed=21, container="recordio")
    gen_s = time.perf_counter() - t
    spec = deepfm.model_spec(**DFM_WIDTH)
    reader = create_data_reader(train)
    batches = [spec.feed(reader.read_records_packed(shard))
               for shard in reader.create_shards(PS_BATCH)[:PS_LOSS_STEPS]]
    routes = ("ragged", "dense")

    # One process, replicated: the reference losses.
    single = Trainer(spec, device="cuda")
    state = single.init_state(0)
    single_losses = []
    for batch in batches:
        state, m = single.run_train_step(state, batch)
        single_losses.append(float(m["loss"]))
    del single, state
    torch.cuda.empty_cache()
    t = time.perf_counter()
    world = _spawn_ranks(_ps_loss_rank, 2, batches, routes)
    world_s = time.perf_counter() - t
    probe = world[0]["probe"]
    log(f"[ps] data: {PS_EPOCH_STEPS * PS_BATCH} records in {gen_s:.1f} s; gloo on card "
        f"tensors (rank 0, rank 1): {probe}, {world[1]['probe']}")
    assert all(v == "ok" for r in world for v in r["probe"].values()), (
        "a collective refused card tensors: " + json.dumps([r["probe"] for r in world]))
    rows = {route: world[0][(route, "rows")] for route in routes}
    diffs = {}
    for route in routes:
        assert world[0][(route, "impl")] == route
        assert world[0][(route, "gang")] == world[1][(route, "gang")]
        for variant in ("gang", "dropped", "summed", "doubled"):
            diffs[(route, variant)] = [abs(a - b) for a, b in
                                       zip(world[0][(route, variant)], single_losses)]
        log(f"[ps] {route}: first {PS_LOSS_STEPS} losses, gang "
            + ", ".join(f"{x:.6f}" for x in world[0][(route, 'gang')]) + " vs one process "
            + ", ".join(f"{x:.6f}" for x in single_losses) + "; |diff| gang "
            + ", ".join(f"{x:.2e}" for x in diffs[(route, 'gang')])
            + f" (limit {PS_LOSS_ABS}); table gradient dropped "
            + ", ".join(f"{x:.2e}" for x in diffs[(route, 'dropped')])
            + "; summed again over the table axis "
            + ", ".join(f"{x:.2e}" for x in diffs[(route, 'summed')])
            + "; doubled " + ", ".join(f"{x:.2e}" for x in diffs[(route, 'doubled')])
            + f"; {rows[route]} table rows a rank; lookup collectives a step (ms, rank 0) "
            + json.dumps({k: round(v, 3) for k, v in world[0][(route, "lookup_ms")].items()})
            + ", calls over the steps " + json.dumps(world[0][(route, "lookup_calls")]))
    # The static ragged route: three equal-split all-to-alls a step, no
    # count all-gather.
    assert world[0][("ragged", "lookup_calls")] == {"all_to_all": 3 * PS_LOSS_STEPS}, (
        world[0][("ragged", "lookup_calls")])
    for route in routes:
        assert max(diffs[(route, "gang")]) <= PS_LOSS_ABS, (route, diffs[(route, "gang")])
        for wrong in ("dropped", "summed"):
            assert max(diffs[(route, wrong)]) > PS_LOSS_ABS, (
                f"the limit cannot see a table gradient {wrong}", route)

    # The jobs.
    jobs = {"dense": _ps_job(card, "dense", train, out, epochs=1, kill=False),
            "ragged": _ps_job(card, "ragged", train, out, epochs=2, kill=True)}
    for route, job in jobs.items():
        for losses in (job["first_losses"], job["first_losses_rank1"]):
            d = [abs(a - b) for a, b in zip(losses, single_losses)]
            assert len(d) == PS_LOSS_STEPS and max(d) <= PS_LOSS_ABS, (route, losses, d)
    replicated = {"tables": table_bytes(26 * DFM_WIDTH["buckets_per_feature"],
                                        DFM_WIDTH["embedding_dim"] + 1)}

    # The ragged job's last checkpoint into a world of one: equal to the
    # gathered live state bit for bit (the ranks' digest of their last
    # snapshot), then one step.
    job = jobs["ragged"]
    ckpt = CheckpointManager(job["ckpt"])
    bare = Trainer(spec, device="cuda")
    t = time.perf_counter()
    state = bare.adopt_restored(ckpt.restore(), bare.init_state(None))
    restore_s = time.perf_counter() - t
    digest = _state_digest(bare.snapshot_state(state))
    replicated["opt"] = sum(bare.opt_state_bytes_per_device(state).values())
    assert state.step == job["final_step"] and digest == job["final_digest"], (
        state.step, job["final_step"], digest, job["final_digest"])
    state, m = bare.run_train_step(state, batches[0])
    assert np.isfinite(float(m["loss"]))
    log(f"[ps] the ragged job's checkpoint at step {job['final_step']} into a world of one: "
        f"equal to the gathered live state bit for bit (digest {digest[:16]}), restored in "
        f"{restore_s:.2f} s, one more step: loss {float(m['loss']):.6f}; the replicated layout "
        f"holds table {replicated['tables'] / 1e6:.2f} MB and optimizer "
        f"{replicated['opt'] / 1e6:.2f} MB a rank")
    del bare, state
    torch.cuda.empty_cache()
    for job in jobs.values():
        shutil.rmtree(job.pop("ckpt"))  # 327 MB a checkpoint: too much for chiprun_out/
    os.remove(train)
    return {"probe": [r["probe"] for r in world], "single_losses": single_losses,
            "world_s": world_s,
            "lookup_ms": {route: [r[(route, "lookup_ms")] for r in world] for route in routes},
            "loss_diffs": {f"{r}/{v}": d for (r, v), d in diffs.items()},
            "table_rows": rows, "jobs": jobs, "replicated_bytes": replicated,
            "restore_s": restore_s}


def _opt_rank(rank, world, batches, ckpt_dir):
    """Phase 12 (b)'s spawned rank: transformer_lm under the sharded
    optimizer; losses, the split of each step, bytes, launches, and the
    digest of the gathered state (rank 0 writes it as a checkpoint)."""
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.worker.main import _state_digest

    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **TRAIN_WIDTH)
    trainer = Trainer(spec, device="cuda", mesh=create_mesh(dcn_parallelism=world),
                      config=JobConfig(optimizer_sharding="sharded", dcn_data_parallelism=world))
    state = trainer.init_state(0)
    auto = trainer._resolve_opt_sharding(trainer._opt_plan, trainer._param_paths(state.model),
                                         mode="auto")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()  # the steps start here
    losses, step_s, by_step = [], [], []
    for batch in batches:
        before = dict(trainer.reducer.by_op)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.run_train_step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        by_step.append({k: v - before.get(k, 0.0) for k, v in trainer.reducer.by_op.items()})
    launches = {n: kernels.counts().get(n, 0) for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}
    peak = torch.cuda.max_memory_allocated()
    opt_bytes = sum(trainer.opt_state_bytes_per_device(state).values())
    t = time.perf_counter()
    snap = trainer.snapshot_state(state)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t
    digest = _state_digest(snap)
    if rank == 0:
        CheckpointManager(ckpt_dir).save(state.step, trainer.to_host(snap), wait=True)
    return {"losses": losses, "step_s": step_s, "by_step": by_step, "launches": launches,
            "peak": peak, "opt_bytes": opt_bytes, "gather_s": gather_s, "digest": digest,
            "auto_sharded": auto, "step": state.step}


def phase_opt_shard(card: str) -> dict:
    """Phase 12 (b): the sharded optimizer on transformer_lm at phase 4's
    width over two spawned ranks of the card (module docstring)."""
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.data.codecs import encode_lm_example
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.worker.main import _state_digest

    spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=False, **TRAIN_WIDTH)
    rng = np.random.default_rng(12)
    global_batch = 2 * OPT_BATCH
    toks = _planted_sequences(rng, global_batch * OPT_STEPS, TRAIN_WIDTH["seq_len"],
                              TRAIN_WIDTH["vocab"])
    records = [encode_lm_example(t) for t in toks]
    batches = [spec.feed(records[i * global_batch:(i + 1) * global_batch])
               for i in range(OPT_STEPS)]
    single = Trainer(spec, device="cuda")
    state = single.init_state(0)
    single_losses = []
    for batch in batches:
        state, m = single.run_train_step(state, batch)
        single_losses.append(float(m["loss"]))
    replicated_opt = sum(single.opt_state_bytes_per_device(state).values())
    del single, state
    torch.cuda.empty_cache()
    ckpt_dir = os.path.join(REPO, "chiprun_out", "opt_shard")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t = time.perf_counter()
    ranks = _spawn_ranks(_opt_rank, 2, batches, ckpt_dir)
    world_s = time.perf_counter() - t
    diffs = [abs(a - b) for a, b in zip(ranks[0]["losses"], single_losses)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert max(diffs) <= GANG_LOSS_ABS, (ranks[0]["losses"], single_losses, diffs)
    assert all(r["auto_sharded"] for r in ranks), "auto must shard 887 MB of moments"
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for r in ranks:
        assert r["opt_bytes"] <= replicated_opt / 2 + (1 << 20), (r["opt_bytes"], replicated_opt)
    # The gathered state after the steps into a world of one, bit for bit.
    ckpt = CheckpointManager(ckpt_dir)
    bare = Trainer(spec, device="cuda")
    state = bare.adopt_restored(ckpt.restore(), bare.init_state(None))
    digest = _state_digest(bare.snapshot_state(state))
    assert state.step == OPT_STEPS and digest == ranks[0]["digest"], (digest, ranks[0]["digest"])
    del bare, state
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)  # 1.33 GB
    # The split of a step (rank 0, the steps after the first): reduce-scatter,
    # all-gather, the loss's all-reduce and the rest (compute and launches).
    r0 = ranks[0]
    later = range(1, OPT_STEPS)
    split = {
        "step_ms": statistics.median(r0["step_s"][i] for i in later) * 1e3,
        "reduce_scatter_ms": statistics.median(
            r0["by_step"][i].get("zero:reduce_scatter", 0.0) for i in later) * 1e3,
        "all_gather_ms": statistics.median(
            r0["by_step"][i].get("zero:all_gather", 0.0) for i in later) * 1e3,
        "loss_all_reduce_ms": statistics.median(
            r0["by_step"][i].get("grads:all_reduce", 0.0) for i in later) * 1e3,
    }
    split["compute_ms"] = split["step_ms"] - sum(v for k, v in split.items() if k != "step_ms")
    launches = {n: sum(r["launches"][n] for r in ranks) for n in (fa.KERNEL, fa.DQ_KERNEL,
                                                                   fa.DKV_KERNEL)}
    layers = TRAIN_WIDTH["n_layers"]
    assert launches == {n: 2 * layers * OPT_STEPS for n in launches}, launches
    log(f"[zero] transformer_lm, 2 ranks x batch {OPT_BATCH}, --optimizer_sharding=sharded "
        f"(auto resolves to sharded too): losses " + ", ".join(f"{x:.6f}" for x in r0["losses"])
        + " vs one process at batch 16 " + ", ".join(f"{x:.6f}" for x in single_losses)
        + f"; |diff| " + ", ".join(f"{x:.2e}" for x in diffs) + f" (limit {GANG_LOSS_ABS}); "
        f"optimizer bytes a rank {r0['opt_bytes'] / 1e6:.1f} / {ranks[1]['opt_bytes'] / 1e6:.1f} "
        f"MB against the replicated {replicated_opt / 1e6:.1f} MB; peak allocated "
        f"{r0['peak'] / 2**30:.2f} / {ranks[1]['peak'] / 2**30:.2f} GiB; gathered state equal "
        f"to a world of one's restore bit for bit; on {card}")
    log("[zero] step split (ms, rank 0, p50 of steps 2-4): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + f"; the state's gathers {r0['gather_s']:.2f} s;"
        f" world wall {world_s:.1f} s; launches " + json.dumps(launches))
    return {"losses": r0["losses"], "single_losses": single_losses, "abs_diff": diffs,
            "opt_bytes": [r["opt_bytes"] for r in ranks], "replicated_opt_bytes": replicated_opt,
            "peak_bytes": [r["peak"] for r in ranks], "split": split, "launches": launches,
            "gather_s": r0["gather_s"], "world_s": world_s}


# Phase 13: the PS host tier on the card.  Host-tier DeepFM at the width
# whose table "auto" promotes to the host store (2^20 buckets a feature:
# 27,262,976 rows, 5.2 GB with two Adam moments, past the 4 GiB HBM guard),
# dim 8, MLP 400-400, batch 8192, bf16 over f32.
HOST_WIDTH = dict(buckets_per_feature=1 << 20, embedding_dim=8, hidden=(400, 400))
HOST_BATCH, HOST_PARITY_STEPS, HOST_WARM, HOST_SPLIT_STEPS = 8192, 3, 5, 5
# (a) Sync against async on one store: HOST_PAIRS pairs of HOST_PAIR_STEPS
# timed steps each way, the order alternating from pair to pair.
# Three pairs: the ratio question was settled over 18 earlier pairs (async
# slower in 14; PERF.md), and the script's time limit is shared.
HOST_PAIRS, HOST_PAIR_STEPS = 3, 10
# (b) One epoch of 131,072 records: 4 tasks of 4 minibatches, a checkpoint
# every 8 steps, an eval round at the end; the worker stalls at its first
# task boundary past the first checkpoint while PS shard 1 is SIGKILLed.
HOST_JOB, HOST_MB_PER_TASK, HOST_TASKS, HOST_CKPT_STEPS = "chip13", 4, 4, 8
HOST_VAL, HOST_STALL_MS = 20000, 10000
# (c) 64 requests of 8 examples; skewed ids (zipf, a = 1.2, over each
# feature's id range), the first 16 the warm-up of the hot-id cache.
HOST_REQUESTS, HOST_REQUEST_ROWS, HOST_WARM_REQUESTS = 64, 8, 16
HOST_DEVICE = "cuda"
# (a) The stores' rows after the card's and the CPU's 3 steps: the share of
# touched row values that differ by more than 1e-4.  The store's adagrad
# moves a value by lr * g / (sqrt(sum g^2) + eps) with lr 0.01: about
# +-lr at a value's first update whatever |g|, so a value whose gradient is
# float noise on both sides (a near-cancelling sum) takes +-0.01 at random,
# and the rows it feeds move the next steps' gradients a little.  Set from
# the card's reading (NVIDIA H100 80GB HBM3, 700 W: 204 of 5,634,873
# values, 3.6e-5, largest 0.0188) with room; a lost or doubled push, or a
# wrong id, moves about a third of the values (a step's 1.9 million).
HOST_ROW_FLIPS = 2e-4


def _host_batches(n: int, seed: int, rows: int = HOST_BATCH) -> list:
    """``n`` raw Criteo batches as ``criteo_feed`` decodes them, drawn as
    ``data/synthetic.synthetic_criteo`` draws its records (dense integers
    below 1000, ids below 2^20, the planted label rule)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.integers(0, 1000, (rows, 13))
        cat = rng.integers(0, 1 << 20, (rows, 26))
        score = 0.002 * dense[:, 0] - 0.001 * dense[:, 1] + ((cat[:, 0] % 7) - 3) * 0.3
        labels = (rng.random(rows) < 1 / (1 + np.exp(-score))).astype(np.int32)
        out.append({"dense": dense.astype(np.float32), "cat": cat.astype(np.int32),
                    "labels": labels})
    return out


def _sync() -> None:
    if HOST_DEVICE == "cuda":
        torch.cuda.synchronize()


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        kb = next(int(x.split()[1]) for x in f if x.startswith("VmRSS:"))
    return kb / 2**20


def _host_timed(trainer, state, batches: list, use_async: bool) -> tuple:
    """``run_train_steps`` over ``batches``, stamping the host clock each
    time the loop takes its next batch: (state, per-step ms, examples/s)."""
    stamps = []

    def stamped():
        for b in batches:
            stamps.append(time.perf_counter())
            yield b

    state, metrics = trainer.run_train_steps(state, stamped(), use_async=use_async)
    _sync()
    stamps.append(time.perf_counter())
    assert np.isfinite(float(metrics[-1]["loss"]))
    step_ms = list(np.diff(stamps) * 1e3)
    return state, step_ms, len(batches) * HOST_BATCH / (stamps[-1] - stamps[0])


def _host_split(trainer, state, batches: list) -> tuple:
    """The synchronous step in its parts, one batch at a time: the pull
    (host), the upload of the batch and the rows (CUDA events), the device
    step with the rows' gradient copy to pinned memory inside it (CUDA
    events), the host's wait for that copy, the push (host); medians."""
    from elasticdl_tpu_torch.parallel.trainer import HostGrad

    parts = {k: [] for k in ("pull", "h2d", "device", "wait", "push", "enqueue")}
    for batch in batches:
        t0 = time.perf_counter()
        rows, ids = trainer._pull_host_rows(batch)
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        placed = trainer.shard_batch(batch)
        placed.update((k, trainer._to_device(v)) for k, v in rows.items())
        ev[1].record()
        t2 = time.perf_counter()
        state, _, grads = trainer.train_step(state, placed)
        ev[2].record()
        t3 = time.perf_counter()
        for g in grads.values():
            g.numpy()
        t4 = time.perf_counter()
        trainer._push_host_grads(ids, grads)
        t5 = time.perf_counter()
        torch.cuda.synchronize()
        parts["pull"].append((t1 - t0) * 1e3)
        parts["h2d"].append(ev[0].elapsed_time(ev[1]))
        parts["device"].append(ev[1].elapsed_time(ev[2]))
        parts["enqueue"].append((t3 - t2) * 1e3)
        parts["wait"].append((t4 - t3) * 1e3)
        parts["push"].append((t5 - t4) * 1e3)
    grad = torch.randn(HOST_BATCH, 26, 9, device="cuda")
    d2h = time_ms(lambda: HostGrad(grad))  # the copy alone: 7.67 MB to pinned memory
    split = {k: statistics.median(v) for k, v in parts.items()}
    split["d2h"] = d2h
    return state, split


def _host_job(card: str, out: str) -> dict:
    """(b) The CLI job with ``--num_ps_pods=2 --use_async`` on the card:
    PS shard 1 SIGKILLed after the first checkpoint; its relaunch restores
    its slice, the job ends at the epoch's step count."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
    from elasticdl_tpu_torch.models.deepfm import HOST_FM_KEY
    from elasticdl_tpu_torch.ps.service import snapshot_filename

    t = time.perf_counter()
    train = synthetic_criteo(os.path.join(out, "train.rio"),
                             HOST_TASKS * HOST_MB_PER_TASK * HOST_BATCH, seed=13,
                             container="recordio")
    val = synthetic_criteo(os.path.join(out, "val.rio"), HOST_VAL, seed=14,
                           container="recordio")
    gen_s = time.perf_counter() - t
    ckpt, pods = os.path.join(out, "ckpt"), os.path.join(out, "pods")
    steps = HOST_TASKS * HOST_MB_PER_TASK
    w0, ps1 = f"{HOST_JOB}-worker-0", f"{HOST_JOB}-ps-1"
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={HOST_JOB}", "--model_def=deepfm.model_spec", "--learning_rate=1e-3",
           "--model_params=" + ";".join(
               f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
               for k, v in HOST_WIDTH.items()),
           f"--training_data={train}", f"--validation_data={val}",
           f"--minibatch_size={HOST_BATCH}", f"--num_minibatches_per_task={HOST_MB_PER_TASK}",
           "--num_epochs=1", f"--evaluation_steps={steps}",
           f"--checkpoint_steps={HOST_CKPT_STEPS}", f"--checkpoint_dir={ckpt}",
           f"--pod_log_dir={pods}", "--num_ps_pods=2", "--use_async=true",
           "--max_worker_relaunch=2",
           f"--chaos=stall:worker={w0},point=task,step={HOST_CKPT_STEPS},ms={HOST_STALL_MS}"]
    cli_path = os.path.join(out, "cli.log")
    first = os.path.join(ckpt, "host_stores", str(HOST_CKPT_STEPS))
    t0 = time.time()
    proc = _start_cli(cmd, cli_path)
    try:
        _wait_for(lambda: all(os.path.exists(os.path.join(first, snapshot_filename(
            HOST_FM_KEY, s, 2))) for s in range(2)), "the first host-store snapshot", proc,
            timeout_s=400)
        _wait_for(lambda: "[graftchaos] stall" in _read(os.path.join(pods, f"{w0}.log")),
                  "the worker's stall past the first checkpoint", proc, timeout_s=120)
        pid = _ps_pid(_read(os.path.join(pods, f"{ps1}.log")))
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)
        rc = proc.wait(timeout=400)
        wall_s = time.time() - t0
    finally:
        _stop_cli(proc)
    cli = _read(cli_path)
    assert rc == 0, f"the host-tier job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    relaunch = _read(os.path.join(pods, f"{ps1}-r1.log"))
    restored = next(x for x in relaunch.splitlines() if "restored PS shard 1 from step" in x)
    relaunch_s = _log_time(relaunch, "PS shard 1/2 serving") - t_kill
    ev = _worker_events(_read(os.path.join(pods, f"{w0}.log")))
    summary = ev["summary"]
    manifest = read_manifest(ckpt)
    assert status["finished"] and status["done"] == HOST_TASKS and status["abandoned"] == 0, status
    assert manifest["step"] == summary["step"] == steps, (manifest, summary["step"])
    assert restored.rstrip().endswith(f"from step {HOST_CKPT_STEPS}"), restored
    assert f"pod {ps1} exited rc=-9 -> Failed" in cli
    auc = status["eval_metrics"]["auc"]
    assert status["eval_rounds"] >= 1 and 0.0 < auc < 1.0, status
    assert summary["launches"] == {} or not any(summary["launches"].values())
    p50 = statistics.median(summary["step_ms"]) if summary["step_ms"] else float("nan")
    for s in range(2):
        assert os.path.exists(os.path.join(ckpt, "host_stores", str(steps),
                                           snapshot_filename(HOST_FM_KEY, s, 2)))
    log(f"[host] (b) CLI job: data {gen_s:.1f} s; rc {rc} in {wall_s:.1f} s; {status['done']} "
        f"tasks, step {summary['step']}; SIGKILL of PS shard 1 after the step-"
        f"{HOST_CKPT_STEPS} snapshot, relaunched and serving after {relaunch_s:.2f} s ("
        f"{restored.split('] ', 3)[-1]}); job step p50 {p50:.2f} ms (CUDA events between "
        f"step ends, {summary['steps']} steps); eval AUC {auc:.4f}; on {card}")
    log(f"[host] (b) worker phases (s): " + json.dumps(
        {k: round(v, 3) for k, v in summary["phase_times"].items() if v}))
    for path in (train, val):
        os.remove(path)
    return {"wall_s": wall_s, "gen_s": gen_s, "relaunch_s": relaunch_s,
            "restored": restored.split("] ", 3)[-1], "step_p50_ms": p50,
            "steps": summary["steps"], "eval": status["eval_metrics"], "ckpt": ckpt,
            "manifest_step": manifest["step"], "phase_times": summary["phase_times"]}


def _ps_pid(text: str) -> int:
    """The pid in a PS pod's "PS shard i/n serving ... (pid N)" line."""
    line = next(x for x in text.splitlines() if "serving" in x and "(pid " in x)
    return int(line.rsplit("(pid ", 1)[1].split(")")[0])


def _host_serving(card: str, ckpt: str) -> dict:
    """(c) A replica on the card over (b)'s checkpoint, its rows from a
    2-shard PS fleet restored from the same directory, behind the hot-id
    cache: 64 requests; a publish invalidates the cache, and the answers are
    then a fresh pull's."""
    from elasticdl_tpu_torch.common import gauge as gaugelib
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.ps.service import PSServer, RemoteEmbeddingStore
    from elasticdl_tpu_torch.serving.client import ServingClient
    from elasticdl_tpu_torch.serving.server import ServingServer

    spec = deepfm.model_spec(**HOST_WIDTH)
    key = deepfm.HOST_FM_KEY
    fleet = [PSServer(spec.host_io, shard=s, num_shards=2, gauges=gaugelib.Registry())
             for s in range(2)]
    t = time.perf_counter()
    restored = [s.restore_latest(ckpt) for s in fleet]
    restore_s = time.perf_counter() - t
    for s in fleet:
        s.start()
    addrs = ",".join(s.address for s in fleet)
    server = ServingServer(spec, checkpoint_dir=ckpt, ps_addresses=addrs, max_batch=64,
                           batch_buckets=[HOST_REQUEST_ROWS], max_delay_ms=2,
                           poll_interval_s=3600, device=HOST_DEVICE).start()
    client = ServingClient(server.address)
    rng = np.random.default_rng(15)
    offsets = np.arange(26)

    def request():
        ids = (rng.zipf(1.2, (HOST_REQUEST_ROWS, 26)) * 7919 + offsets * 104729) % (1 << 20)
        return {"dense": rng.integers(0, 1000, (HOST_REQUEST_ROWS, 13)).astype(np.float32),
                "cat": ids.astype(np.int32)}

    try:
        client.wait_ready(30.0)
        warm_s = server.warmup()
        live_step = server.live_step
        walls, stats0 = [], None
        for i in range(HOST_REQUESTS):
            if i == HOST_WARM_REQUESTS:
                stats0 = client.model_info()["cache"][key]
            feats = request()
            t = time.perf_counter()
            outs = client.predict(feats)["outputs"]
            walls.append((time.perf_counter() - t) * 1e3)
            assert len(outs) == HOST_REQUEST_ROWS and all(0.0 <= o <= 1.0 for o in outs)
        stats = client.model_info()["cache"][key]
        hits, misses = stats["hits"] - stats0["hits"], stats["misses"] - stats0["misses"]
        hit_rate = hits / max(hits + misses, 1)
        # The flush alone, on one full bucket: the rows come from the cache.
        batch = dict(feats, __mask__=np.ones(HOST_REQUEST_ROWS, np.float32))
        flush_ms = []
        for _ in range(20):
            t = time.perf_counter()
            server._run_batch(dict(batch), HOST_REQUEST_ROWS)
            flush_ms.append((time.perf_counter() - t) * 1e3)
        # Training pushes under the replica, then a publish: the cache is
        # emptied, and the next answer equals a fresh pull's on the same model.
        before = np.asarray(client.predict(feats)["outputs"])
        ids = np.unique(spec.host_io[key].ids_fn(feats))
        store = RemoteEmbeddingStore(key, spec.host_io[key].dim, addrs.split(","))
        for _ in range(30):
            store.push_grad(ids, np.ones((ids.size, store.dim), np.float32))
        store.close()
        assert np.array_equal(np.asarray(client.predict(feats)["outputs"]), before)
        mgr = CheckpointManager(ckpt)
        mgr.save(live_step + 1, mgr.restore(live_step), wait=True)
        mgr.publish(live_step + 1)
        invalidations = client.model_info()["cache"][key]["invalidations"]
        assert server._watcher.poke()
        info = client.model_info()
        assert info["step"] == live_step + 1
        assert info["cache"][key]["invalidations"] == invalidations + 1
        assert info["cache"][key]["size"] == 0
        after = np.asarray(client.predict(feats)["outputs"])
        fresh = Trainer(spec, device=HOST_DEVICE, config=JobConfig(ps_addresses=addrs))
        with server._state_lock:
            model = server._live.state
        want = fresh.run_predict_step(model, feats).float().cpu().numpy()
        moved = float(np.abs(after - before).max())
        fresh_err = float(np.abs(after - want).max())
        assert moved > 1e-4 and fresh_err <= 1e-6, (moved, fresh_err)
    finally:
        client.close()
        server.stop(grace=0)
        for s in fleet:
            s.stop(grace=0)
    p50_req, p50_flush = statistics.median(walls), statistics.median(flush_ms)
    log(f"[host] (c) replica over (b)'s step {live_step} with a 2-shard fleet (restored "
        f"{restored} in {restore_s:.2f} s; warm-up {warm_s:.2f} s): {HOST_REQUESTS} requests "
        f"of {HOST_REQUEST_ROWS}, request p50 {p50_req:.3f} ms, flush p50 {p50_flush:.3f} ms; "
        f"hot-id cache hit rate after {HOST_WARM_REQUESTS} warm-up requests {hit_rate:.4f} "
        f"({hits} hits, {misses} misses, {stats['size']} rows); after 30 pushes and a publish "
        f"the cache was emptied and the answers moved by {moved:.4g}, equal to a fresh "
        f"pull's within {fresh_err:.3g}; on {card}")
    return {"restored": restored, "restore_s": restore_s, "request_p50_ms": p50_req,
            "flush_p50_ms": p50_flush, "hit_rate": hit_rate, "cache": stats,
            "moved": moved, "fresh_err": fresh_err}


def phase_host_tier(card: str) -> dict:
    """Phase 13: the PS host tier on the card.  (a) In process: "auto"
    resolves the full-width table to the host tier; the card against the
    CPU at f32 over 3 steps, each side with a fresh store; on one store, 5
    warm steps and pairs of timed sync and use_async (depth 1) runs at
    B=8192, the order alternating, with the sync step in its parts; the
    store's rows and the process's resident memory.
    (b) The CLI job with two PS pods, one SIGKILLed.  (c) A replica with
    ``ps_addresses`` behind the hot-id cache."""
    import shutil

    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    t_phase = time.perf_counter()
    out = os.path.join(REPO, "chiprun_out", "host")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    launched = dict(kernels.counts())
    key = deepfm.HOST_FM_KEY
    spec = deepfm.model_spec(**HOST_WIDTH)
    assert sorted(spec.host_io) == [key] and not spec.embedding_tables, "auto -> host tier"

    # (a) The card against the CPU at f32, 3 steps, fresh stores each side.
    # Held at DFM_F32_REL (norm over norm): every step's loss, and the first
    # step's row gradients (pushed) and dense gradients, which both sides
    # compute from the same weights and rows; the stores' rows after the 3
    # steps at HOST_ROW_FLIPS (see there).  The later steps' gradients are
    # reported: they start from rows that differ by those flips.
    spec32 = deepfm.model_spec(**HOST_WIDTH, compute_dtype="float32")
    sides = {}
    batches = _host_batches(HOST_PARITY_STEPS, seed=31)
    tree = None
    for dev in ("cpu", HOST_DEVICE):
        tr = Trainer(spec32, device=dev)
        state = tr.init_state(0 if tree is None else None)
        if tree is None:
            tree = deepfm.params_to_jax(state.model)
        else:
            state.model.load_jax_params(tree)
        pushed = []
        store = tr._host_stores[key]
        push = store.push_grad
        store.push_grad = lambda i, g, push=push, pushed=pushed: (pushed.append(np.array(g)),
                                                                  push(i, g))[1]
        state, metrics = tr.run_train_steps(state, batches[:1])
        first = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        state, more = tr.run_train_steps(state, batches[1:])
        sides[dev] = (tr, state, [float(m["loss"]) for m in metrics + more], pushed, first)
    (ctr, cs, closs, cpush, cfirst), (gtr, gs, gloss, gpush, gfirst) = (
        sides["cpu"], sides[HOST_DEVICE])
    parity = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in enumerate(zip(gloss, closs))}
    parity["row_grad0"] = _rel(torch.from_numpy(gpush[0]), torch.from_numpy(cpush[0]))
    parity.update({f"grad0/{n}": _rel(g, cfirst[n]) for n, g in gfirst.items()})
    later = {f"row_grad{i}": _rel(torch.from_numpy(gpush[i]), torch.from_numpy(cpush[i]))
             for i in range(1, HOST_PARITY_STEPS)}
    ids = np.unique(np.concatenate([spec.host_io[key].ids_fn(b).ravel() for b in batches]))
    rows = {dev: sides[dev][0]._host_stores[key].pull(ids) for dev in sides}
    diff = np.abs(rows[HOST_DEVICE] - rows["cpu"])
    flips = int((diff > 1e-4).sum())
    rows_rel = _rel(torch.from_numpy(rows[HOST_DEVICE]), torch.from_numpy(rows["cpu"]))
    cpu_params = dict(cs.model.named_parameters())
    params_rel = {n: _rel(p, cpu_params[n]) for n, p in gs.model.named_parameters()}
    worst = max(parity, key=parity.get)
    log(f"[host] (a) card vs CPU, f32, {HOST_PARITY_STEPS} steps of {HOST_BATCH}: losses "
        + ", ".join(f"{x:.6f}" for x in gloss) + " (rel " + ", ".join(
            f"{parity[f'loss{i}']:.3g}" for i in range(HOST_PARITY_STEPS))
        + f"); step 1's row gradients {parity['row_grad0']:.3g}; largest held reading {worst} "
        f"{parity[worst]:.3g} (limit {DFM_F32_REL}); later steps' row gradients "
        + ", ".join(f"{v:.3g}" for v in later.values()) + f"; {ids.size} touched rows: rel "
        f"{rows_rel:.3g}, {flips} of {diff.size} values off by more than 1e-4 (largest "
        f"{diff.max():.3g}; limit a share of {HOST_ROW_FLIPS}); parameters after the steps "
        "rel " + json.dumps({k: float(f"{v:.3g}") for k, v in params_rel.items()}))
    assert all(v <= DFM_F32_REL for v in parity.values()), parity
    assert flips <= HOST_ROW_FLIPS * diff.size, (flips, diff.size)
    parity.update(later, rows=rows_rel, row_flips=flips, row_values=int(diff.size),
                  params_after=params_rel)
    del sides, ctr, cs, gtr, gs, rows, diff

    # (a) After 5 warm steps, HOST_PAIRS pairs of a sync and an async
    # (depth 1) run on one trainer and store, the order alternating (sync
    # first in even pairs): a drift along the call (the store fills) moves
    # both halves of a pair alike, and each pair gives its own ratio.  Then
    # the sync step in its parts.
    tr = Trainer(spec, device=HOST_DEVICE, config=JobConfig(async_staleness=1))
    state = tr.init_state(0)
    state, _ = tr.run_train_steps(state, _host_batches(HOST_WARM, seed=40))
    # The store's own time in each pull and push call (host clock; a push's
    # wait for its gradients comes before the call).
    store = tr._host_stores[key]
    spent = {"pull": [], "push": []}

    def timed(fn, name):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            spent[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    store.pull, store.push_grad = timed(store.pull, "pull"), timed(store.push_grad, "push")
    pairs = []
    for i in range(HOST_PAIRS):
        pair = {}
        for j, mode in enumerate(("sync", "async") if i % 2 == 0 else ("async", "sync")):
            batches = _host_batches(HOST_PAIR_STEPS, seed=41 + 2 * i + j)
            for v in spent.values():
                v.clear()
            state, step_ms, eps = _host_timed(tr, state, batches, mode == "async")
            pair[mode] = {"p50_ms": statistics.median(step_ms), "examples_per_s": eps,
                          "pull_ms": statistics.median(spent["pull"]),
                          "push_ms": statistics.median(spent["push"])}
        pair["ratio"] = pair["async"]["p50_ms"] / pair["sync"]["p50_ms"]
        pairs.append(pair)
    del store.pull, store.push_grad
    ratios = [p["ratio"] for p in pairs]
    ratio = statistics.median(ratios)
    store_rows = len(tr._host_stores[key])
    rss = _rss_gib()
    state, split = _host_split(tr, state, _host_batches(HOST_SPLIT_STEPS, seed=42))

    log(f"[host] (a) in process at B={HOST_BATCH}, one store, {HOST_WARM} warm-up steps, then "
        f"{HOST_PAIRS} pairs of {HOST_PAIR_STEPS} steps sync and async (depth 1), sync first "
        "in even pairs; p50 ms sync/async (ratio): " + "; ".join(
            f"{p['sync']['p50_ms']:.2f}/{p['async']['p50_ms']:.2f} ({p['ratio']:.3f})"
            for p in pairs)
        + f"; median ratio {ratio:.3f} (range {min(ratios):.3f}-{max(ratios):.3f}); examples/s "
        f"sync {statistics.median(p['sync']['examples_per_s'] for p in pairs):.0f}, async "
        f"{statistics.median(p['async']['examples_per_s'] for p in pairs):.0f} (medians); "
        "the store's pull and push ms, sync/async (medians a run): " + "; ".join(
            f"{p['sync']['pull_ms']:.2f}/{p['async']['pull_ms']:.2f} and "
            f"{p['sync']['push_ms']:.2f}/{p['async']['push_ms']:.2f}" for p in pairs)
        + f"; store rows {store_rows} after all runs; the process's resident memory "
        f"{rss:.2f} GiB; on {card}")
    log("[host] (a) the sync step's parts (ms, medians of "
        f"{HOST_SPLIT_STEPS}): pull {split['pull']:.3f}, H2D {split['h2d']:.3f} (events), device "
        f"{split['device']:.3f} (events, the gradient's copy out included; host enqueue "
        f"{split['enqueue']:.3f}), wait for the copy {split['wait']:.3f}, push "
        f"{split['push']:.3f}; the 7.67 MB D2H copy alone {split['d2h']:.4f}")
    del tr, state
    torch.cuda.empty_cache()

    # (b) The job, then (c) serving over its checkpoint.
    job = _host_job(card, out)
    serving = _host_serving(card, job["ckpt"])
    shutil.rmtree(job["ckpt"])  # the host stores' snapshots: too much to bring back
    assert kernels.counts() == launched, "phase 13 launches no flash kernel"
    wall = time.perf_counter() - t_phase
    log(f"[host] phase 13 in {wall:.1f} s")
    return {"config": dict(HOST_WIDTH, batch=HOST_BATCH, compute_dtype="bfloat16",
                           table_rows=26 * HOST_WIDTH["buckets_per_feature"]),
            "parity": parity, "pairs": pairs, "async_over_sync": ratio, "split": split,
            "rss_gib": rss, "job": job, "serving": serving, "wall_s": wall}


# ---- phase 14: the model zoo ------------------------------------------------------

# The reference bench's widths and batches (tools/bench_all.py:41-80):
# MNIST at the zoo default; ResNet-50 (stages 3-4-6-3, width 64, CIFAR
# stem, GroupNorm(8)); Wide&Deep at 65536 buckets a feature, dim 8, MLP
# 100-50, its two tables row-sharded under the ParameterServer strategy (a
# world of one).  Each model's own optimizer and learning rate.
ZOO_WIDTH = {
    "mnist": {},
    "resnet50": dict(depth=50, width=64),
    "wide_deep": dict(buckets=65536, embedding_dim=8, hidden=(100, 50)),
}
ZOO_STRATEGY = {"mnist": "AllReduce", "resnet50": "AllReduce", "wide_deep": "ParameterServer"}
ZOO_BATCH = {"mnist": 4096, "resnet50": 512, "wide_deep": 8192}
# (a) Card against CPU at f32 (TF32 off), 3 steps from the same weights.
# Held at ZOO_F32_REL: every step's loss (relative), step 1's gradient of
# every parameter and all parameters after the steps as one vector (error
# norm over norm).  The single leaves after the steps are logged, not held:
# ResNet-50 at lr 0.1 on batches of 8 amplifies f32 noise (its loss rises
# 2.5 -> 13 -> 78 over the 3 steps; on the CPU a 1e-6 relative change of the
# weights moved a GroupNorm bias by 3.2e-4 relative after them, and all
# parameters together by 6.4e-6).
ZOO_PARITY_BATCH = {"mnist": 64, "resnet50": 8, "wide_deep": 8192}
ZOO_PARITY_STEPS = 3
ZOO_F32_REL = 1e-4
# (b) bench.py's protocol in bf16: 5 warm-up steps, 30 timed.
ZOO_WARM, ZOO_STEPS = 5, 30
# (c) The CLI job: 16 tasks of one minibatch of 8192 census rows in a
# SQLite table, an eval round on ZOO_VAL rows and a checkpoint at step 16.
ZOO_JOB_TASKS, ZOO_VAL = 16, 20000
# (d) The replica: 16 requests of one bucket each.
ZOO_REQUESTS, ZOO_REQUEST_ROWS = 16, 64
ZOO_DEVICE = "cuda"
CENSUS_COLUMNS = ["label", "age", "education_num", "capital_gain", "capital_loss",
                  "hours_per_week", "workclass", "education", "marital_status", "occupation",
                  "relationship", "race", "sex", "native_country", "extra_cat"]
# Profiler kernel-name fragments of the ResNet-50 step's groups: the
# convolutions and GEMMs (cuDNN and cuBLAS, their layout transposes
# included), the SGD update (foreach kernels); GroupNorm's reductions and
# the elementwise passes are the rest of the kernels but for these.
_ZOO_GROUPS = (
    ("sgd", ("multi_tensor_apply", "sgd")),
    ("conv_gemm", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad", "wgrad", "sm90",
                   "cutlass", "nhwc", "nchw", "winograd", "gemm", "nvjet", "dot_kernel")),
    ("norm_elementwise", ("elementwise", "reduce", "norm", "vectorized", "unrolled", "copy",
                          "fill", "pad", "cat", "pool", "index", "softmax", "nll", "where")),
)


def _zoo_module(name: str):
    from elasticdl_tpu_torch.models import cifar10_resnet, mnist, wide_deep

    return {"mnist": mnist, "resnet50": cifar10_resnet, "wide_deep": wide_deep}[name]


def _zoo_records(name: str, n: int, seed: int, out: str) -> list:
    """``n`` synthetic records of the model's dataset, through the file
    the generator writes (RecordIO images, census CSV lines)."""
    from elasticdl_tpu_torch.data import synthetic
    from elasticdl_tpu_torch.data.recordio import RecordIOReader

    family = {"mnist": "mnist", "resnet50": "cifar10", "wide_deep": "census"}[name]
    path = os.path.join(out, f"{family}-{seed}.data")
    synthetic.generate(family, path, n, seed=seed)
    if family == "census":
        with open(path, "rb") as f:
            records = [line for line in f.read().split(b"\n") if line]
    else:
        records = list(RecordIOReader(path).read_range(0, n))
    os.remove(path)
    return records


def _zoo_batches(spec, records: list, batch: int) -> list:
    return [spec.feed(records[i:i + batch]) for i in range(0, len(records), batch)]


def _zoo_trainer(spec, name: str, device: str):
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    return Trainer(spec, device=device, config=JobConfig(distribution_strategy=ZOO_STRATEGY[name]))


def _zoo_parity(name: str, out: str) -> dict:
    """(a) 3 f32 steps on the card and on the CPU from the port's own init,
    copied: each step's loss, step 1's gradients, the parameters after."""
    mod = _zoo_module(name)
    spec = mod.model_spec(compute_dtype="float32", **ZOO_WIDTH[name])
    n = ZOO_PARITY_BATCH[name]
    batches = _zoo_batches(spec, _zoo_records(name, ZOO_PARITY_STEPS * n, 1, out), n)
    sides, tree = {}, None
    for dev in ("cpu", ZOO_DEVICE):
        tr = _zoo_trainer(spec, name, dev)
        state = tr.init_state(0 if tree is None else None)
        if tree is None:
            tree = mod.params_to_jax(state.model)
        else:
            state.model.load_jax_params(tree)
        # Step 1's gradients from a backward of their own: the optimizer may
        # rewrite .grad in place (SGD nesterov's foreach update on the card
        # adds the momentum into it).
        placed = tr.shard_batch(batches[0])
        spec.loss(tr._apply(state.model, placed, train=True), placed).backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in state.model.named_parameters()}
        state.model.zero_grad(set_to_none=True)
        state, metrics = tr.run_train_steps(state, batches)
        sides[dev] = ([float(m["loss"]) for m in metrics], grads,
                      {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()})
        del tr, state
    (closs, cgrad, cparam), (gloss, ggrad, gparam) = sides["cpu"], sides[ZOO_DEVICE]
    held = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in enumerate(zip(gloss, closs))}
    held.update({f"grad0/{k}": _rel(g, cgrad[k]) for k, g in ggrad.items()})
    held["params"] = _rel(torch.cat([p.reshape(-1) for p in gparam.values()]),
                          torch.cat([p.reshape(-1) for p in cparam.values()]))
    leaves = {k: _rel(p, cparam[k]) for k, p in gparam.items()}
    worst, worst_leaf = max(held, key=held.get), max(leaves, key=leaves.get)
    log(f"[zoo] (a) {name} card vs CPU, f32, {ZOO_PARITY_STEPS} steps of {n}: losses "
        + ", ".join(f"{x:.6f}" for x in gloss) + " (CPU " + ", ".join(f"{x:.6f}" for x in closs)
        + f"); all parameters after the steps {held['params']:.3g}; largest held reading "
        f"{worst} {held[worst]:.3g} (limit {ZOO_F32_REL}); largest single parameter after the "
        f"steps {worst_leaf} {leaves[worst_leaf]:.3g}")
    assert all(v <= ZOO_F32_REL for v in held.values()), (name, held)
    return {"losses": gloss, "cpu_losses": closs, "held": {worst: held[worst],
            "params": held["params"]}, "worst_leaf": [worst_leaf, leaves[worst_leaf]]}


def _step_flops(spec, trainer, batch: dict, rows: int) -> float:
    """Operations of one training step at ``rows`` examples: the matrix
    products and convolutions of a forward and backward on a 2-example
    slice, counted by ``FlopCounterMode``, scaled."""
    from torch.utils.flop_counter import FlopCounterMode

    small = trainer.shard_batch({k: v[:2] for k, v in batch.items()})
    model = trainer.init_state(None).model
    counter = FlopCounterMode(display=False)
    with counter:
        trainer._apply(model, small, train=True).float().sum().backward()
    return counter.get_total_flops() / 2 * rows


def _zoo_timed(name: str, out: str, card: str) -> dict:
    """(b) The model at its bench batch in bf16: 5 warm-up steps and 30
    timed on one placed batch (bench.py's protocol); step p50 from CUDA
    events at each step's end, examples/s, peak memory; the loss must fall
    over the timed steps.  ResNet-50 also gets a profile split."""
    mod = _zoo_module(name)
    spec = mod.model_spec(**ZOO_WIDTH[name])
    n = ZOO_BATCH[name]
    [batch] = _zoo_batches(spec, _zoo_records(name, n, 2, out), n)
    trainer = _zoo_trainer(spec, name, ZOO_DEVICE)
    flops = _step_flops(spec, trainer, batch, n) if name != "wide_deep" else 0.0
    state = trainer.init_state(0)
    placed = trainer.shard_batch(batch)
    for _ in range(ZOO_WARM):
        state = trainer.train_step(state, placed)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(ZOO_STEPS + 1)]
    losses = []
    t = time.perf_counter()
    ends[0].record()
    for i in range(ZOO_STEPS):
        state, metrics, _ = trainer.train_step(state, placed)
        losses.append(metrics["loss"])
        ends[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / ZOO_STEPS
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    p50 = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    result = {"batch": n, "p50_step_ms": p50, "host_ms_per_step": host_ms,
              "examples_per_s": n / p50 * 1e3, "peak_gib": peak / 2**30,
              "loss_first5": first, "loss_last5": last, "step_flops": flops}
    bound = ""
    if flops:
        result["bound_ms"] = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        bound = (f"; {flops / 1e12:.3f} TFLOP a step (convolutions and products), bound "
                 f"{result['bound_ms']:.3f} ms at 989 TFLOP/s, {result['bound_ms'] / p50:.3f} of it")
    log(f"[zoo] (b) {name} bf16 at B={n} ({ZOO_STEPS} steps after {ZOO_WARM} warm-up): step "
        f"p50 {p50:.3f} ms (CUDA events; min {min(step_ms):.3f}, max {max(step_ms):.3f}), host "
        f"clock {host_ms:.3f} ms a step, {n / p50 * 1e3:.0f} examples/s, peak memory "
        f"{peak / 2**30:.3f} GiB{bound}; loss {first:.4f} -> {last:.4f} (means of the first and "
        f"last 5 timed steps) on {card}")
    assert all(np.isfinite(losses)) and last < first, (name, losses)
    if name == "resnet50":
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = trainer.train_step(state, placed)[0]
        enqueue_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        holder = [state]

        def one_step():
            holder[0] = trainer.train_step(holder[0], placed)[0]

        split = _dfm_breakdown(one_step, _ZOO_GROUPS)
        result.update(enqueue_ms=enqueue_ms, split=split)
        log(f"[zoo] (b) resnet50 one step: host enqueue {enqueue_ms:.3f} ms, device busy "
            f"{split['device_ms']:.3f} ms in {split['kernels']} kernels: "
            + json.dumps(split["groups_ms"]) + f" (norm_elementwise = GroupNorm's reductions and "
            f"the elementwise passes; rest = the other kernels) on {card}")
        log("[zoo] (b) resnet50 top kernels: " + json.dumps(split["top_kernels_ms"]))
        log(f"[zoo] (b) resnet50 host, profiled: {split['host_ms']:.3f} ms self time; top "
            "operators: " + json.dumps(split["top_host_ops_ms"][:8]))
    del trainer, state, placed
    torch.cuda.empty_cache()
    return result


def _census_table(path: str, n: int, seed: int) -> str:
    """A SQLite census table of ``n`` synthetic rows (``write_table``)."""
    from elasticdl_tpu_torch.data.synthetic import synthetic_census
    from elasticdl_tpu_torch.data.table import write_table

    csv = path + ".csv"
    synthetic_census(csv, n, seed)
    with open(csv) as f:
        rows = [line.split(",") for line in f.read().splitlines() if line]
    os.remove(csv)
    write_table(path, rows, CENSUS_COLUMNS)
    return path


def _zoo_cli(out: str, card: str) -> dict:
    """(c) ``python -m elasticdl_tpu_torch.client.main train
    --model_def=wide_deep.model_spec`` at full width under the
    ParameterServer strategy with ``--prep_depth=2``, its training data a
    SQLite census table: one worker process on the card, an eval round
    (AUC) and a checkpoint at the last step."""
    import ast

    from elasticdl_tpu_torch.common.checkpoint import read_manifest

    t = time.perf_counter()
    n = ZOO_JOB_TASKS * ZOO_BATCH["wide_deep"]
    train = _census_table(os.path.join(out, "train.db"), n, 21)
    val = _census_table(os.path.join(out, "val.db"), ZOO_VAL, 22)
    gen_s = time.perf_counter() - t
    ckpt, pods = os.path.join(out, "ckpt"), os.path.join(out, "pods")
    w = ZOO_WIDTH["wide_deep"]
    params = (f"buckets={w['buckets']};embedding_dim={w['embedding_dim']};"
              f"hidden={','.join(str(h) for h in w['hidden'])}")
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           "--job_name=chip14", "--model_def=wide_deep.model_spec", f"--model_params={params}",
           "--distribution_strategy=ParameterServer", "--prep_depth=2", "--learning_rate=1e-3",
           f"--training_data={train}", f"--validation_data={val}",
           f"--minibatch_size={ZOO_BATCH['wide_deep']}", "--num_minibatches_per_task=1",
           "--num_epochs=1", f"--evaluation_steps={ZOO_JOB_TASKS}",
           f"--checkpoint_steps={ZOO_JOB_TASKS}", f"--checkpoint_dir={ckpt}",
           f"--pod_log_dir={pods}"]
    log_path = os.path.join(out, "cli.log")
    t = time.perf_counter()
    proc = _start_cli(cmd, log_path)
    try:
        rc = proc.wait(timeout=300)
    finally:
        _stop_cli(proc)
    wall = time.perf_counter() - t
    text = _read(log_path)
    assert rc == 0, f"the Wide&Deep CLI job exited {rc}; see {log_path}"
    line = next(x for x in text.splitlines() if "job finished: " in x)
    status = ast.literal_eval(line.split("job finished: ", 1)[1])
    pod_log = _read(os.path.join(pods, "chip14-worker-0.log"))
    events = _worker_events(pod_log)
    summary = events["summary"]
    pool = next(x for x in pod_log.splitlines() if "prep pool: " in x)
    width = int(pool.split("prep pool: ", 1)[1].split(" ", 1)[0])
    manifest = read_manifest(ckpt)
    auc = status["eval_metrics"]["auc"]
    log(f"[zoo] (c) CLI job: tables written in {gen_s:.1f} s ({n} training rows, {ZOO_VAL} "
        f"validation rows); rc {rc} in {wall:.1f} s; {status['done']} tasks, step "
        f"{summary['step']}, prep pool width {width} (prep_depth 2, the table reader declares "
        f"no thread_safe_ranges); eval " + json.dumps(status["eval_metrics"])
        + f"; manifest step {manifest['step']}; worker phase times "
        + json.dumps(summary.get("phase_times", {})) + f"; state bytes "
        + json.dumps(summary.get("state_bytes", {})) + f" on {card}")
    assert status["done"] == ZOO_JOB_TASKS and summary["step"] == ZOO_JOB_TASKS
    assert width == 1, pool
    assert status["eval_rounds"] >= 1 and 0.5 < auc < 1.0, status["eval_metrics"]
    assert manifest["step"] == ZOO_JOB_TASKS
    for path in (train, val):
        os.remove(path)
    return {"wall_s": wall, "gen_s": gen_s, "prep_pool_width": width,
            "eval_metrics": status["eval_metrics"], "summary_step": summary["step"],
            "phase_times": summary.get("phase_times"), "ckpt": ckpt,
            "manifest_step": manifest["step"]}


def _zoo_replica(ckpt: str, step: int, out: str, card: str) -> dict:
    """(d) A replica on the card over (c)'s checkpoint: 16 Predict
    requests of one bucket each, equal to ``predict`` on the checkpoint's
    weights in process."""
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.models import wide_deep
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.serving.client import ServingClient
    from elasticdl_tpu_torch.serving.server import ServingServer

    spec = wide_deep.model_spec(**ZOO_WIDTH["wide_deep"])
    records = _zoo_records("wide_deep", ZOO_REQUESTS * ZOO_REQUEST_ROWS, 23, out)
    feats = [{k: v for k, v in b.items() if k != "labels"}
             for b in _zoo_batches(spec, records, ZOO_REQUEST_ROWS)]
    server = ServingServer(spec, checkpoint_dir=ckpt, max_batch=ZOO_REQUEST_ROWS,
                           batch_buckets=[ZOO_REQUEST_ROWS], max_delay_ms=2,
                           poll_interval_s=3600, device=ZOO_DEVICE).start()
    client = ServingClient(server.address)
    try:
        client.wait_ready(60.0)
        assert server.live_step == step, (server.live_step, step)
        walls, answers = [], []
        for f in feats:
            t = time.perf_counter()
            answers.append(np.asarray(client.predict(f)["outputs"], np.float32))
            walls.append((time.perf_counter() - t) * 1e3)
    finally:
        client.close()
        server.stop(grace=0)
    trainer = Trainer(spec, device=ZOO_DEVICE)
    state = trainer.adopt_restored(CheckpointManager(ckpt).restore(step))
    want = [trainer.run_predict_step(state.model, f).float().cpu().numpy() for f in feats]
    err = max(float(np.abs(a - w).max()) for a, w in zip(answers, want))
    p50 = statistics.median(walls)
    log(f"[zoo] (d) replica over step {step}: {ZOO_REQUESTS} requests of {ZOO_REQUEST_ROWS} "
        f"rows, request p50 {p50:.3f} ms; answers in [{min(a.min() for a in answers):.4f}, "
        f"{max(a.max() for a in answers):.4f}], largest difference from predict in process "
        f"{err:.3g} on {card}")
    assert all(a.shape == (ZOO_REQUEST_ROWS,) for a in answers)
    assert err <= 1e-6, err
    return {"request_p50_ms": p50, "max_abs_err": err}


def phase_zoo(card: str) -> dict:
    """Phase 14: the model zoo on the card.  (a) MNIST, ResNet-50 and
    Wide&Deep at full width, card against CPU at f32 over 3 steps; (b) each
    at its bench batch in bf16, timed, with ResNet-50's profile split; (c)
    the Wide&Deep CLI job from a SQLite table under the ParameterServer
    strategy; (d) a replica over its checkpoint."""
    import shutil

    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.ps import host_store

    t_phase = time.perf_counter()
    out = os.path.join(REPO, "chiprun_out", "zoo")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    launched = dict(kernels.counts())
    host_store._load()  # the census decode's native library, built from the checkout
    report = {"parity": {}, "timed": {}}
    for name in ZOO_WIDTH:
        report["parity"][name] = _zoo_parity(name, out)
    torch.cuda.empty_cache()
    for name in ZOO_WIDTH:
        report["timed"][name] = _zoo_timed(name, out, card)
    job = _zoo_cli(out, card)
    report["job"] = job
    report["replica"] = _zoo_replica(job["ckpt"], job["manifest_step"], out, card)
    shutil.rmtree(job["ckpt"])  # ~0.1 GB a checkpoint: too much to bring back
    assert kernels.counts() == launched, "phase 14 launches no flash kernel"
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[zoo] phase 14 in {report['wall_s']:.1f} s")
    return report


# Phase 15: transformer_lm across ranks at phase 4's width, gloo ranks on
# card tensors (NCCL refuses two ranks on one card, phase 11 (b)).
#
# (a) The ring over RING_WORLDS spawned ranks at the training attention
# shape (B=16, global L=1024, H=12, D=64), causal, in both dtypes: each
# rank's output shard and gradient shards (of sum(out * cot)) against
# attention_reference over the whole sequence on one process, in f32 from
# the same inputs.  Relative error norms ("rel": |got - ref| / |ref|, of the
# output and of each gradient).  Each limit must reject two wrong rings,
# computed on one process as masked plain attention: one that skips the
# first rotated block, one that masks with local positions.  Set from the
# readings on the card (NVIDIA H100 80GB HBM3, 700 W; 2 and 4 ranks alike:
# bf16 1.61e-3 to 1.66e-3, one output rounding; f32 3.0e-7 to 7.6e-7) with
# room on both sides: the wrong rings read 0.81 to 1.10 in both dtypes.
RING_WORLDS = (2, 4)
RING_B = 16
RING_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# (b)-(c): global batch RT_BATCH, RT_STEPS steps, from init_state(0), the
# losses against one process on the same batches from the same weights
# (remat on: the rotations and the tp sums replay in the backward).  Set
# from the readings on the card (NVIDIA H100 80GB HBM3, 700 W), in bf16:
# the ring 1.7e-5 to 6.1e-5 (its f32 einsums against the flash kernels),
# tp 3.2e-5 to 3.6e-4 on (dp 1, tp 2) and (dp 2, tp 2) (two bf16 partial
# sums against one product); in f32 both 0 to 9.5e-7.  Each limit must
# reject its wrong version, whose largest |diff| over the steps read: a
# ring that never rotates 8.5e-3 (bf16) and 8.3e-3 (f32), tp without f
# 1.17e-2 and 1.18e-2.
RT_BATCH, RT_STEPS, RT_DTYPE = 8, 4, "bfloat16"
RING_LOSS_ABS = {"bfloat16": 5e-4, "float32": 1e-5}
TP_LOSS_ABS = {"bfloat16": 2e-3, "float32": 1e-5}
# (d) The CLI job: --multihost --num_workers=2 --tensor_parallelism=2 over
# the first RT_CLI_TRAIN of phase 7's training sequences (the same seed: one
# epoch of 4 tasks, 16 steps) and phase 7's validation file, eval rounds and
# checkpoints (GANG_FLAGS), remat off as in the other CLI phases.
RT_JOB = "chip15"
RT_CLI_TRAIN = 256


def _ring_inputs(seed: int, dtype, device: str = "cuda") -> list:
    """q, k, v and the cotangent, [RING_B, LT, HT, DT], from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(RING_B, LT, HT, DT, generator=g).to(device=device, dtype=dtype)
            for _ in range(4)]


def _masked_attention(q, k, v, mask) -> torch.Tensor:
    """Plain attention over ``[B, L, H, D]`` with an explicit ``[L, L]``
    mask: the wrong rings' outputs on one process."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ring_masks(n: int) -> dict:
    """The causal mask of the right ring and of the two wrong ones, on the
    card: ``skip`` drops each query block's first rotated key block (rank
    r's keys from rank r-1), ``local`` compares positions within the
    blocks instead of global ones."""
    pos = torch.arange(LT, device="cuda")
    block = pos // (LT // n)
    causal = pos[:, None] >= pos[None, :]
    return {
        "skip": causal & (block[None, :] != (block[:, None] - 1) % n),
        "local": (pos % (LT // n))[:, None] >= (pos % (LT // n))[None, :],
        "right": causal,
    }


def _rel_norm(got, ref) -> float:
    return float((got.float() - ref).norm() / ref.norm())


def _ring_readings(shards: dict, masks: dict, dtype) -> dict:
    """The ring's (``shards``: output and gradients, concatenated over
    the ranks) and the wrong rings' relative errors against the f32
    reference."""
    q, k, v, cot = (t.float().requires_grad_(i < 3)
                    for i, t in enumerate(_ring_inputs(15, dtype)))
    out = {}
    for name in ("right", "skip", "local"):
        for t in (q, k, v):
            t.grad = None
        o = _masked_attention(q, k, v, masks[name])
        (o * cot).sum().backward()
        if name == "right":
            ref = [o.detach()] + [t.grad.clone() for t in (q, k, v)]
            got = shards
        else:
            got = [o.detach()] + [t.grad.clone() for t in (q, k, v)]
        out[name] = [_rel_norm(g, r) for g, r in zip(got, ref)]
        del o
    return out


def _lm_batches(n_steps: int, batch: int, seed: int) -> list:
    from elasticdl_tpu_torch.data.codecs import encode_lm_example
    from elasticdl_tpu_torch.data.codecs import lm_feed

    rng = np.random.default_rng(seed)
    toks = _planted_sequences(rng, batch * n_steps, TRAIN_WIDTH["seq_len"], TRAIN_WIDTH["vocab"])
    records = [encode_lm_example(t) for t in toks]
    return [lm_feed(records[i * batch:(i + 1) * batch]) for i in range(n_steps)]


def _lm_run(trainer, batches: list) -> dict:
    """``batches`` through ``trainer`` from ``init_state(0)``: each step's
    loss, host seconds and collective seconds by op; the flash launches;
    the digest of the gathered state and this rank's matmul-weight bytes."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.worker.main import _state_digest

    state = trainer.init_state(0)
    torch.cuda.synchronize()
    kernels.reset_counts()  # the steps start here
    losses, step_s, by_step = [], [], []
    for batch in batches:
        before = dict(trainer.reducer.by_op)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.run_train_step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        by_step.append({k: v - before.get(k, 0.0) for k, v in trainer.reducer.by_op.items()})
    launches = {n: kernels.counts().get(n, 0) for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}
    snap = trainer.snapshot_state(state)
    torch.cuda.synchronize()
    weights = sum(int(p.nbytes) for name, p in state.model.named_parameters()
                  if name.rsplit(".", 1)[-1] in ("wqkv", "wo", "w1", "w2"))
    return {"losses": losses, "step_s": step_s, "by_step": by_step, "launches": launches,
            "digest": _state_digest(snap), "matmul_bytes": weights, "state": state,
            "snapshot": snap}


class _Stay:
    """A wrong ring's rotation: each rank keeps its own key and value
    blocks."""

    @staticmethod
    def apply(k, v, reducer, group):
        return k, v


def _ring_tp_rank(rank, world, plan, dtype):
    """Phase 15's spawned rank: the ring cases over the world's flat mesh,
    then each ``transformer_lm`` run of ``plan`` (``(name, parallelism,
    create_mesh kwargs, fault, checkpoint directory)``; ``fault``:
    ``"no_f"`` leaves *f* out of the tensor path, ``"no_rotation"`` keeps
    each rank's own key and value blocks at every ring step)."""
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import kernels
    from elasticdl_tpu_torch.ops import ring_attention as ra
    from elasticdl_tpu_torch.ops.embedding import ParallelContext
    from elasticdl_tpu_torch.parallel import collectives as coll
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    out = {"ring": {}, "lm": {}}
    mesh = create_mesh()
    reducer = coll.Reducer(mesh)
    group = mesh.group(("dp",))
    # The tp sum of a bf16 card tensor over gloo (values whose every
    # partial sum is exact in bf16), against the f32 sum.
    probe = torch.full((3,), 0.5 * (rank + 1), device="cuda", dtype=torch.bfloat16)
    want = torch.full((3,), sum(0.5 * (r + 1) for r in range(world)), device="cuda")
    out["bf16_sum_exact"] = bool(torch.equal(coll.tp_all_reduce(probe, reducer, group),
                                             want.to(torch.bfloat16)))
    ctx = ParallelContext(axis_name="dp", axis_size=world, axis_index=rank, group=group,
                          reducer=reducer)
    s = LT // world
    for ring_dtype in (torch.bfloat16, torch.float32):
        q, k, v, cot = (t[:, rank * s:(rank + 1) * s] for t in _ring_inputs(15, ring_dtype))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_counts()
        o = ra.ring_attention(*leaves, axis_name="dp", causal=True, ctx=ctx)
        (o.float() * cot.float()).sum().backward()
        launches = sum(kernels.counts().get(n, 0) for n in (fa.KERNEL, fa.DQ_KERNEL,
                                                            fa.DKV_KERNEL))
        # As f32 numpy (exact for bf16): the queue shares tensors through
        # file descriptors that close with this process.
        shards = [t.detach().float().cpu().numpy() for t in [o] + [x.grad for x in leaves]]
        times = []
        for _ in range(3):
            for t in leaves:
                t.grad = None
            before = reducer.by_op.get("ring:p2p", 0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = ra.ring_attention(*leaves, axis_name="dp", causal=True, ctx=ctx)
            (o.float() * cot.float()).sum().backward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0, reducer.by_op["ring:p2p"] - before))
        out["ring"][str(ring_dtype)] = {
            "shards": shards, "launches": launches,
            "fwd_bwd_ms": statistics.median(a for a, _ in times) * 1e3,
            "p2p_ms": statistics.median(b for _, b in times) * 1e3,
        }
        del leaves, o
    torch.cuda.empty_cache()
    batches = _lm_batches(RT_STEPS, RT_BATCH, 15)
    for name, parallelism, mesh_kw, fault, save in plan:
        spec = transformer_lm.model_spec(compute_dtype=dtype, parallelism=parallelism,
                                         **TRAIN_WIDTH)
        trainer = Trainer(spec, device="cuda", mesh=create_mesh(**mesh_kw))
        real_f, real_rotate = transformer_lm.tp_grad_sync, ra._Rotate
        if fault == "no_f":
            transformer_lm.tp_grad_sync = lambda x, reducer, group: x
        if fault == "no_rotation":
            ra._Rotate = _Stay
        try:
            run = _lm_run(trainer, batches)
        finally:
            transformer_lm.tp_grad_sync, ra._Rotate = real_f, real_rotate
        if save and rank == 0:
            CheckpointManager(save).save(run["state"].step, trainer.to_host(run["snapshot"]),
                                         wait=True)
        del run["state"], run["snapshot"]
        run["shape"] = dict(trainer.mesh.shape)
        out["lm"][name] = run
        del trainer
        torch.cuda.empty_cache()
    return out


def _lm_single(parallelism: str, batches: list, dtype: str) -> dict:
    """One process on the same batches from the same weights."""
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    spec = transformer_lm.model_spec(compute_dtype=dtype, parallelism=parallelism,
                                     **TRAIN_WIDTH)
    run = _lm_run(Trainer(spec, device="cuda"), batches)
    del run["state"], run["snapshot"]
    torch.cuda.empty_cache()
    return run


def _rt_cli(card: str) -> dict:
    """(d): the CLI's local mode, --multihost --num_workers=2
    --tensor_parallelism=2, over phase 7's files."""
    import ast
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import read_manifest
    from elasticdl_tpu_torch.data.synthetic import synthetic_lm

    out = os.path.join(REPO, "chiprun_out", "job")
    val = os.path.join(out, "val.rio")
    assert os.path.exists(val), "phase 7 writes the job's data"
    train = synthetic_lm(os.path.join(out, "train15.rio"), RT_CLI_TRAIN, seed=0,
                         seq_len=TRAIN_WIDTH["seq_len"], vocab=TRAIN_WIDTH["vocab"])
    ckpt, pods = os.path.join(out, "ckpt15"), os.path.join(out, "pods15")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(pods, ignore_errors=True)
    params = ";".join(f"{k}={v}" for k, v in TRAIN_WIDTH.items())
    cmd = [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train", "--local",
           f"--job_name={RT_JOB}", "--model_def=transformer_lm.model_spec",
           f"--model_params={params};compute_dtype=bfloat16;remat=false;parallelism=tensor",
           "--learning_rate=3e-4", f"--training_data={train}", f"--validation_data={val}",
           f"--checkpoint_dir={ckpt}", f"--pod_log_dir={pods}", "--num_workers=2",
           "--multihost=true", "--tensor_parallelism=2", f"--coordinator_port={_free_port()}"]
    cmd += [f"--{k}={v}" for k, v in GANG_FLAGS.items()]
    torch.cuda.empty_cache()
    os.environ["ELASTICDL_TORCH_DIST_BACKEND"] = "gloo"
    os.environ["ELASTICDL_STATE_DIGEST"] = "1"
    cli_path = os.path.join(out, "cli15.log")
    t0 = time.time()
    try:
        proc = _start_cli(cmd, cli_path)
    finally:
        del os.environ["ELASTICDL_TORCH_DIST_BACKEND"], os.environ["ELASTICDL_STATE_DIGEST"]
    try:
        rc = proc.wait(timeout=600)
    finally:
        _stop_cli(proc)
    wall_s = time.time() - t0
    cli = _read(cli_path)
    assert rc == 0, f"the job exited {rc}; see {cli_path}"
    status = ast.literal_eval(cli.split("job finished: ", 1)[1].splitlines()[0])
    names = [f"{RT_JOB}-worker-{r}" for r in (0, 1)]
    logs = {n: _read(os.path.join(pods, f"{n}.log")) for n in names}
    ev = {n: _worker_events(t) for n, t in logs.items()}
    digests = {n: {json.loads(x[len("[worker-event] "):])["step"]:
                   json.loads(x[len("[worker-event] "):])["digest"]
                   for x in t.splitlines() if x.startswith("[worker-event] ")
                   and '"event": "checkpoint"' in x} for n, t in logs.items()}
    per_task = GANG_FLAGS["minibatch_size"] * GANG_FLAGS["num_minibatches_per_task"]
    n_tasks = RT_CLI_TRAIN // per_task
    epoch_steps = n_tasks * GANG_FLAGS["num_minibatches_per_task"]
    _assert_fused_gang(logs)
    assert status["finished"] and status["done"] == n_tasks, status
    assert status["abandoned"] == 0 and status["duplicate_done"] == 0, status
    assert status["eval_rounds"] >= 1 and np.isfinite(status["eval_metrics"]["loss"]), status
    for n in names:
        assert ev[n]["gang"]["mesh"] == {"dp": 1, "tp": 2}, ev[n]["gang"]
        summary = ev[n]["summary"]
        assert summary["step"] == epoch_steps and summary["state_bytes"]["sharded_state"]
        # The tensor path's attention is the plain version: no flash kernel.
        assert not any(summary["launches"].values()), summary["launches"]
    sa, sb = ev[names[0]]["summary"], ev[names[1]]["summary"]
    assert sa["tasks"] == sb["tasks"]
    shared = sorted(set(digests[names[0]]) & set(digests[names[1]]))
    assert shared and all(digests[names[0]][k] == digests[names[1]][k] for k in shared), digests
    manifest = read_manifest(ckpt)
    assert manifest["step"] == epoch_steps, manifest
    p50 = statistics.median(sa["step_ms"])
    tp_s = sa["collective_by_op"].get("tp:all_reduce", 0.0)
    log(f"[ring_tp] (d) CLI --multihost --num_workers=2 --tensor_parallelism=2 on "
        f"{RT_CLI_TRAIN} of phase 7's sequences: {status['done']} tasks done ({n_tasks} a "
        f"epoch), {status['abandoned']} "
        f"abandoned, {status['duplicate_done']} duplicates, {status['eval_rounds']} eval "
        f"rounds (loss {status['eval_metrics']['loss']:.4f}), final step {manifest['step']}, "
        f"digests equal at steps {shared}; step p50 {p50:.2f} ms (device events, rank 0), "
        f"tp all-reduce {tp_s:.2f} s in all, state bytes {sa['state_bytes']}; "
        f"job wall {wall_s:.1f}s; on {card}")
    shutil.rmtree(ckpt)  # 1.33 GB a checkpoint
    return {"status": {k: status[k] for k in ("done", "abandoned", "duplicate_done",
                                              "eval_rounds", "eval_metrics")},
            "final_step": manifest["step"], "p50_step_ms": p50, "tp_all_reduce_s": tp_s,
            "wall_s": wall_s, "digest_steps": shared}


def phase_ring_tp(card: str, dtype: str = RT_DTYPE) -> dict:
    """Phase 15: the ring and tensor parallelism at phase 4's width over
    spawned gloo ranks on the card (module docstring); ``dtype``: the
    compute dtype of (b) and (c)."""
    import shutil

    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.parallel.trainer import Trainer
    from elasticdl_tpu_torch.worker.main import _state_digest

    t_phase = time.perf_counter()
    ckpt = os.path.join(REPO, "chiprun_out", "ring_tp")
    shutil.rmtree(ckpt, ignore_errors=True)
    plans = {
        2: [("ring_dp2", "sequence", {}, None, None),
            ("ring_dp2_no_rotation", "sequence", {}, "no_rotation", None),
            ("tp_dp1_tp2", "tensor", dict(tensor_parallelism=2), None, None),
            ("tp_dp1_tp2_no_f", "tensor", dict(tensor_parallelism=2), "no_f", None)],
        4: [("tp_dp2_tp2", "tensor", dict(tensor_parallelism=2), None, ckpt)],
    }
    torch.cuda.empty_cache()
    worlds = {}
    for n in RING_WORLDS:
        t = time.perf_counter()
        worlds[n] = _spawn_ranks(_ring_tp_rank, n, plans[n], dtype)
        log(f"[ring_tp] world of {n}: {time.perf_counter() - t:.1f} s")
    report = {"ring": {}, "lm": {}}

    # (a) The ring against the whole-sequence reference, and the wrong rings.
    for n in RING_WORLDS:
        ranks = worlds[n]
        assert all(r["bf16_sum_exact"] for r in ranks), "gloo's bf16 sum of card tensors"
        masks = _ring_masks(n)
        for ring_dtype in (torch.bfloat16, torch.float32):
            key = str(ring_dtype)
            shards = [torch.from_numpy(np.concatenate([r["ring"][key]["shards"][j] for r in ranks],
                                                      axis=1)).to("cuda") for j in range(4)]
            readings = _ring_readings(shards, masks, ring_dtype)
            del shards
            limit = RING_TOL[ring_dtype]
            right = readings["right"]
            log(f"[ring_tp] (a) ring over {n} ranks, {key}: rel error of out, dq, dk, dv "
                + ", ".join(f"{x:.2e}" for x in right) + f" (limit {limit:.0e}); a ring that "
                "skips the first rotated block reads " + ", ".join(
                    f"{x:.2e}" for x in readings["skip"]) + "; one that masks with local "
                "positions " + ", ".join(f"{x:.2e}" for x in readings["local"])
                + f"; fwd+bwd {ranks[0]['ring'][key]['fwd_bwd_ms']:.2f} ms, of it p2p "
                f"{ranks[0]['ring'][key]['p2p_ms']:.2f} ms (rank 0, host clock)")
            assert max(right) <= limit, (n, key, right)
            for wrong in ("skip", "local"):
                assert max(readings[wrong]) > limit, (n, key, wrong, readings[wrong])
            assert all(r["ring"][key]["launches"] == 0 for r in ranks)
            report["ring"][f"{n}/{key}"] = {
                "rel": right, "skip": readings["skip"], "local": readings["local"],
                "fwd_bwd_ms": [r["ring"][key]["fwd_bwd_ms"] for r in ranks],
                "p2p_ms": [r["ring"][key]["p2p_ms"] for r in ranks]}
        torch.cuda.empty_cache()

    # (b) and (c): the losses against one process, the ranks' states.
    batches = _lm_batches(RT_STEPS, RT_BATCH, 15)
    single = {p: _lm_single(p, batches, dtype) for p in ("sequence", "tensor")}
    # One process: the sequence path's flash kernels (a forward replayed
    # under remat), none on the tensor path's plain attention.
    _check_job_launches(single["sequence"]["launches"], TRAIN_WIDTH["n_layers"], RT_STEPS,
                        RT_STEPS)
    assert not any(single["tensor"]["launches"].values()), single["tensor"]["launches"]
    runs = {name: [r["lm"][name] for r in worlds[n]]
            for n in RING_WORLDS for name, *_ in plans[n]}
    for name, ranks in runs.items():
        parallelism = "tensor" if name.startswith("tp") else "sequence"
        ref = single[parallelism]
        limit = (TP_LOSS_ABS if parallelism == "tensor" else RING_LOSS_ABS)[dtype]
        diffs = [abs(a - b) for a, b in zip(ranks[0]["losses"], ref["losses"])]
        later = range(1, RT_STEPS)
        r0 = ranks[0]
        step_ms = statistics.median(r0["step_s"][i] for i in later) * 1e3
        p2p = statistics.median(r0["by_step"][i].get("ring:p2p", 0.0) for i in later) * 1e3
        tp_ms = statistics.median(r0["by_step"][i].get("tp:all_reduce", 0.0) for i in later) * 1e3
        grads_ms = statistics.median(r0["by_step"][i].get("grads:all_reduce", 0.0)
                                     for i in later) * 1e3
        log(f"[ring_tp] {name} {r0['shape']} {dtype}: losses " + ", ".join(
            f"{x:.6f}" for x in r0["losses"]) + " vs one process " + ", ".join(
            f"{x:.6f}" for x in ref["losses"]) + "; |diff| " + ", ".join(
            f"{x:.2e}" for x in diffs) + f" (limit {limit:.0e}); step p50 {step_ms:.1f} ms "
            f"(host clock, steps 2-{RT_STEPS}), of it ring p2p {p2p:.1f} ms, tp all-reduce "
            f"{tp_ms:.1f} ms, gradient all-reduce {grads_ms:.1f} ms; matmul weights a rank "
            f"{r0['matmul_bytes'] / 1e6:.1f} MB (one process {ref['matmul_bytes'] / 1e6:.1f} MB)"
            f"; flash launches {r0['launches']}")
        assert not any(v for r in ranks for v in r["launches"].values()), name
        report["lm"][name] = {
            "shape": r0["shape"], "losses": r0["losses"], "single_losses": ref["losses"],
            "abs_diff": diffs, "step_ms": step_ms, "p2p_ms": p2p, "tp_all_reduce_ms": tp_ms,
            "grads_all_reduce_ms": grads_ms, "matmul_bytes": r0["matmul_bytes"],
            "single_matmul_bytes": ref["matmul_bytes"]}
        if name.endswith(("no_f", "no_rotation")):
            assert max(diffs) > limit, f"the limit cannot see {name}"
            continue
        assert max(diffs) <= limit, (name, diffs)
        # One state: every rank has the same losses and gathers the same
        # canonical state.
        assert all(r["losses"] == r0["losses"] for r in ranks), [r["losses"] for r in ranks]
        assert len({r["digest"] for r in ranks}) == 1, name
        if parallelism == "tensor":
            assert r0["matmul_bytes"] * r0["shape"]["tp"] == ref["matmul_bytes"]
    log(f"[ring_tp] single-process step p50 (host clock): sequence "
        f"{statistics.median(single['sequence']['step_s'][1:]) * 1e3:.1f} ms (flash kernels), "
        f"tensor {statistics.median(single['tensor']['step_s'][1:]) * 1e3:.1f} ms (plain "
        f"attention)")
    # The gathered (dp 2, tp 2) state into a world of one, bit for bit, and a step.
    spec = transformer_lm.model_spec(compute_dtype=dtype, parallelism="tensor", **TRAIN_WIDTH)
    bare = Trainer(spec, device="cuda")
    state = bare.adopt_restored(CheckpointManager(ckpt).restore(), bare.init_state(None))
    digest = _state_digest(bare.snapshot_state(state))
    assert state.step == RT_STEPS and digest == runs["tp_dp2_tp2"][0]["digest"], digest
    state, m = bare.run_train_step(state, batches[0])
    assert state.step == RT_STEPS + 1 and np.isfinite(float(m["loss"]))
    del bare, state
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt)  # 1.33 GB
    log(f"[ring_tp] (c) the (dp 2, tp 2) gathered state restored into a world of one bit for "
        f"bit and stepped (loss {float(m['loss']):.6f}); on {card}")

    # (d) The CLI job.
    report["cli"] = _rt_cli(card)
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[ring_tp] phase 15 wall {report['wall_s']:.1f} s")
    return report


# Phase 16: the serving fleet.  ``transformer_lm`` at the GPT-2-small layer
# width (dim 768, 12 heads of 64, 12 layers, max_seq 1024, bf16) served by
# replica processes (``python -m elasticdl_tpu_torch.serving.main``) that a
# ``ServingFleetController`` runs through ``ProcessPodBackend`` with one warm
# standby, behind the p2c ``FleetServingClient``, the control loop driven by
# the harness (``poll_once``) as the reference's fleet harness drives it
# (``tools/serving_bench.py:run_fleet_bench``).  Cut: 128 tokens a sequence
# and vocab 8192 (phase 6's cut): a Predict answers with every logit as
# JSON, ~12.5 MB a sequence at vocab 8192 ((b) measures it; ~4x that at
# vocab 32768), and two must fit the gRPC cap (common/rpc.py, 64 MB).
# Random weights from seed 0, published as a checkpoint that every replica
# serves.
FLEET_WIDTH = dict(vocab=8192, dim=768, n_heads=12, n_layers=12, max_seq=1024, seq_len=128)
FLEET_JOB = "chip16"
FLEET_DEVICE = "cuda"
FLEET_BUCKETS = [1, 2]
# Forwards a replica runs before it serves: the startup restore's warm
# forward at the smallest bucket, then one warm-up forward a bucket.
FLEET_WARM_FORWARDS = 1 + len(FLEET_BUCKETS)
# (c) The offered load: one-sequence Predicts at FLEET_QPS a second, open
# loop, FLEET_LOAD_S seconds at 2 and at 3 replicas: 40 requests a window,
# so a window's p90 rests on four samples (its p99 on the top one; longer
# windows do not fit the script's time limit on a slow host beside phases
# 11 (a) and 17).  A Predict answers with
# ~12 MB of JSON that the replica encodes and one client process decodes
# ((b) times both), so the rate sits below one answer a second a replica.
# The retirement runs under bulk-lane traffic at FLEET_BULK_QPS (outside the
# online p99 the law reads).  The SLO target is below one flush, so real
# online traffic breaks it.  (d) offers FLEET_KILL_QPS, which the one
# surviving replica carries while the spare comes up.
FLEET_QPS, FLEET_LOAD_S, FLEET_BULK_QPS, FLEET_KILL_QPS = 2.0, 20.0, 1.0, 1.5
FLEET_AUTOSCALE = dict(min_replicas=2, max_replicas=3, target_p99_ms=1.0, up_consecutive=2,
                       down_consecutive=2, cooldown_polls=1, drain_s=1.5)


class _FleetLoad:
    """Open-loop Predicts at ``qps`` through one ``FleetServingClient``
    from a thread pool, until ``stop()``: every request's wall (ms) and
    every failure (none may happen)."""

    def __init__(self, fc, features: dict, qps: float, lane: str = "online"):
        import threading

        self._fc, self._features, self._qps, self._lane = fc, features, qps, lane
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=f"fleet-load-{lane}", daemon=True)
        self.ms, self.errors = [], []

    def _one(self) -> None:
        t = time.perf_counter()
        try:
            r = self._fc.predict(self._features, timeout_s=120.0, lane=self._lane)
            assert r["model"] == "transformer_lm" and len(r["outputs"]) == 1, r["model"]
            self.ms.append((time.perf_counter() - t) * 1e3)
        except Exception as e:  # counted; the phase fails on any
            self.errors.append(f"{type(e).__name__}: {e}")

    def _run(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=16) as pool:
            t0, i = time.perf_counter(), 0
            while not self._stop.wait(max(0.0, t0 + i / self._qps - time.perf_counter())):
                pool.submit(self._one)
                i += 1

    def start(self) -> "_FleetLoad":
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(300.0)  # the pool drains its requests first
        assert not self._thread.is_alive(), "fleet load did not drain"
        ms = sorted(self.ms)
        return {"lane": self._lane, "offered_qps": self._qps, "ok": len(ms),
                "errors": list(self.errors),
                "p50_ms": float(np.percentile(ms, 50)) if ms else None,
                "p90_ms": float(np.percentile(ms, 90)) if ms else None,
                "p99_ms": float(np.percentile(ms, 99)) if ms else None,
                "max_ms": ms[-1] if ms else None}


def _replica_numbers(maddr: str) -> dict:
    """One replica's /metrics: flash forward launches, flushes by bucket,
    requests answered."""
    from elasticdl_tpu_torch.common.metrics_http import fetch

    fams = fetch(maddr, timeout_s=30.0)

    def samples(name):
        return (fams.get(name) or {"samples": []})["samples"]

    return {
        "launches": sum(s["value"] for s in samples("edl_kernel_launches_total")
                        if s["labels"].get("kernel") == "flash_attention_fwd"),
        "flushes": {s["labels"]["bucket"]: s["value"]
                    for s in samples("edl_serving_bucket_flushes_total") if s["value"]},
        "served": sum(s["value"] for s in samples("edl_serving_requests_total")),
    }


def _check_fleet_replica(name: str, maddr: str, fresh: bool = False) -> dict:
    """A quiescent replica's launch identity: flash forward launches = 12
    x (its flushes + its warm forwards), flushes in buckets 1 and 2 only;
    ``fresh``: nothing served yet, else something served."""
    nums = _replica_numbers(maddr)
    flushes = sum(nums["flushes"].values())
    assert set(nums["flushes"]) <= {str(b) for b in FLEET_BUCKETS}, (name, nums)
    assert nums["launches"] == FLEET_WIDTH["n_layers"] * (flushes + FLEET_WARM_FORWARDS), (
        name, nums)
    assert (nums["served"] == 0 and flushes == 0) if fresh else nums["served"] > 0, (name, nums)
    return dict(nums, name=name)


def _answer_everywhere(fc, maddrs: list, features: dict, max_requests: int = 16) -> dict:
    """The same features through the fleet client, one request at a time,
    until every replica has answered; each answer is attributed to the
    replica whose request counter rose.  {metrics address: [answers]}."""

    def served(m):
        return _replica_numbers(m)["served"]

    answers = {m: [] for m in maddrs}
    for _ in range(max_requests):
        before = {m: served(m) for m in maddrs}
        out = np.asarray(fc.predict(features, timeout_s=120.0)["outputs"], np.float32)
        rose = [m for m in maddrs if served(m) > before[m]]
        assert len(rose) == 1, (rose, before)
        answers[rose[0]].append(out)
        if all(answers.values()):
            return answers
    raise AssertionError(f"not every replica answered in {max_requests} requests: "
                         + str({m: len(a) for m, a in answers.items()}))


def _free_port_run(n: int) -> int:
    """A first port of ``n`` consecutive free ports on localhost."""
    for _ in range(200):
        base = _free_port()
        if base + n >= 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("localhost", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no run of {n} free ports")


def _wait_each_ready(ctl, n: int, t0: float, timeout_s: float = 300.0) -> dict:
    """Seconds from ``t0`` to each replica's first healthy /healthz."""
    from elasticdl_tpu_torch.common.metrics_http import fetch_text

    ready = {}
    deadline = time.perf_counter() + timeout_s
    while len(ready) < n:
        assert time.perf_counter() < deadline, f"only {sorted(ready)} ready in {timeout_s}s"
        for name, _saddr, maddr in ctl.replicas():
            if name in ready:
                continue
            try:
                if '"status"' in fetch_text(maddr, "/healthz", 1.0):
                    ready[name] = time.perf_counter() - t0
            except OSError:
                pass
        time.sleep(0.1)
    return ready


def phase_fleet(card: str) -> dict:
    """Phase 16: the serving fleet on the card (module docstring)."""
    import random
    import shutil

    from elasticdl_tpu_torch.common import gauge as gaugelib
    from elasticdl_tpu_torch.common.checkpoint import CheckpointManager
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.master.pod_manager import ProcessPodBackend
    from elasticdl_tpu_torch.models import transformer_lm
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.parallel.trainer import PARAMS, STEP_KEY, Trainer
    from elasticdl_tpu_torch.serving.client import FleetServingClient
    from elasticdl_tpu_torch.serving.fleet import AutoscaleConfig, ServingFleetController
    from elasticdl_tpu_torch.serving.server import ServingServer

    t_phase = time.perf_counter()
    layers, seq, vocab = FLEET_WIDTH["n_layers"], FLEET_WIDTH["seq_len"], FLEET_WIDTH["vocab"]
    out = os.path.join(REPO, "chiprun_out", "fleet")
    shutil.rmtree(out, ignore_errors=True)
    ckpt, logs = os.path.join(out, "ckpt"), os.path.join(out, "pods")
    os.makedirs(logs)
    torch.cuda.empty_cache()

    # The weights every replica serves: seed 0, published as step 1.
    spec = transformer_lm.model_spec(compute_dtype="bfloat16", **FLEET_WIDTH)
    trainer = Trainer(spec, device=FLEET_DEVICE)
    arrays = {k: v for k, v in trainer.host_state(trainer.init_state(0)).items()
              if k.startswith((PARAMS, STEP_KEY))}
    mgr = CheckpointManager(ckpt)
    mgr.save(1, arrays, wait=True)
    mgr.publish(1)
    del trainer, arrays

    base = _free_port_run(8)  # gRPC on base + slot, /metrics on base + 4 + slot
    mbase = base + 4
    cfg = {
        "model_def": "transformer_lm.model_spec",
        "model_params": dict(FLEET_WIDTH, compute_dtype="bfloat16"),
        "checkpoint_dir": ckpt, "max_batch": max(FLEET_BUCKETS),
        "batch_buckets": FLEET_BUCKETS, "device": FLEET_DEVICE,
        "base_port": base, "metrics_base_port": mbase,
        "target_p99_ms": FLEET_AUTOSCALE["target_p99_ms"],
    }
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    worker_env = {"ELASTICDL_SERVING_CONFIG": json.dumps(cfg), "PYTHONPATH": path}
    state_path = os.path.join(out, "fleet_pods.json")
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.serving.main"]

    def controller(log_dir: str):
        backend = ProcessPodBackend(argv=argv, warm_standby=True, standby_pool=1, log_dir=log_dir)
        return ServingFleetController(
            backend, JobConfig(job_name=FLEET_JOB), base_port=base, metrics_base_port=mbase,
            worker_env=worker_env, state_path=state_path,
            autoscale=AutoscaleConfig(**FLEET_AUTOSCALE), autoscale_enabled=False,
            gauges=gaugelib.Registry(),
        ), backend

    rng = np.random.default_rng(16)
    one = {"tokens": rng.integers(0, vocab, (1, seq)).astype(np.int32)}
    two = {"tokens": rng.integers(0, vocab, (2, seq)).astype(np.int32)}
    report = {"config": dict(cfg, autoscale=FLEET_AUTOSCALE, qps=FLEET_QPS,
                             load_s=FLEET_LOAD_S, bulk_qps=FLEET_BULK_QPS,
                             kill_qps=FLEET_KILL_QPS)}
    ctl, backend = controller(logs)
    ctl2 = backend2 = None
    clients = []
    launches = {}  # replica -> flash launches, read when it was last quiescent
    try:
        # (a) Start and readiness: two cold replicas (the spare parks beside them).
        t0 = time.perf_counter()
        ctl.start(2)
        boot = _wait_each_ready(ctl, 2, t0)
        addrs = sorted(ctl.wait_ready(2, timeout_s=30.0))
        maddr = {name: m for name, _s, m in ctl.replicas()}
        for name, m in maddr.items():
            _check_fleet_replica(name, m, fresh=True)
        log(f"[fleet] (a) 2 replicas cold boot-to-ready (s): "
            + ", ".join(f"{n} {s:.2f}" for n, s in sorted(boot.items())) + f"; on {card}")
        report["cold_boot_s"] = boot

        # (b) The same tokens until every replica answered, at both buckets:
        # equal bit for bit, and within the model limits of one process's
        # forward with the plain attention over the same checkpoint.
        fc = FleetServingClient(addrs, rng=random.Random(16))
        clients.append(fc)
        got = {}
        for key, feats in (("bucket1", one), ("bucket2", two)):
            answers = _answer_everywhere(fc, sorted(maddr.values()), feats)
            flat = [a for per in answers.values() for a in per]
            assert all(np.array_equal(a, flat[0]) for a in flat), key
            assert flat[0].shape == (feats["tokens"].shape[0], seq, vocab), flat[0].shape
            assert np.isfinite(flat[0]).all()
            got[key] = (flat[0], {m: len(a) for m, a in answers.items()})
        ref = ServingServer(spec, checkpoint_dir=ckpt, max_batch=max(FLEET_BUCKETS),
                            batch_buckets=FLEET_BUCKETS, device=FLEET_DEVICE)
        assert ref.live_step == 1, ref.live_step

        # No public surface runs the live model with another attention, so
        # this reads the server's live model.
        def plain_attention(q, k, v, causal):
            return fa.flash_attention_plain(q, k, v, causal)[0]

        parity = {}
        with torch.inference_mode():
            for key, feats in (("bucket1", one), ("bucket2", two)):
                toks = torch.from_numpy(feats["tokens"]).to(FLEET_DEVICE)
                plain = ref._live.state(toks, attention=plain_attention).float().cpu().numpy()
                diff = np.abs(got[key][0] - plain)
                parity[key] = {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
                               "answers_by_replica": got[key][1]}
                assert diff.max() <= MODEL_MAX_ABS and diff.mean() <= MODEL_MEAN_ABS, parity
        ref.stop(grace=0)
        del ref
        torch.cuda.empty_cache()
        log(f"[fleet] (b) answers equal bit for bit on every replica at each bucket; against "
            f"one process's plain attention: " + json.dumps(parity)
            + f" (bounds {MODEL_MAX_ABS}, {MODEL_MEAN_ABS})")
        report["parity"] = parity

        # A Predict's JSON on the host: one bucket-1 answer encoded as the
        # replica's codec does it (nested lists, then json.dumps:
        # serving/server.py, common/rpc.py) and decoded as the client's does
        # (json.loads), on this host's CPU; the median of three each.
        enc, dec = [], []
        for _ in range(3):
            t = time.perf_counter()
            payload = json.dumps({"outputs": got["bucket1"][0].tolist()}).encode()
            enc.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            json.loads(payload.decode())
            dec.append((time.perf_counter() - t) * 1e3)
        codec = {"bytes": len(payload), "encode_ms": float(np.median(enc)),
                 "decode_ms": float(np.median(dec))}
        del payload
        log(f"[fleet] (b) one answer's JSON: {codec['bytes'] / 1e6:.1f} MB, encode "
            f"{codec['encode_ms']:.1f} ms, decode {codec['decode_ms']:.1f} ms (host clock)")
        report["codec"] = codec

        # (c) Scale up on real latency, then down under bulk traffic.
        decisions = [ctl.poll_once(), ctl.poll_once()]  # absorb (a)-(b): baseline, quiet
        load = _FleetLoad(fc, one, FLEET_QPS).start()
        time.sleep(FLEET_LOAD_S / 2)
        decisions.append(ctl.poll_once())
        time.sleep(FLEET_LOAD_S / 2)
        decisions.append(ctl.poll_once())
        t_up = time.perf_counter()
        at2 = load.stop()
        assert [d["action"] for d in decisions] == ["", "", "", "up"], decisions
        assert decisions[2]["up_streak"] == 1 and decisions[2]["slo"] >= 1.0, decisions
        addrs3 = ctl.wait_ready(3, timeout_s=300.0)
        adopt_s = time.perf_counter() - t_up
        new = f"{FLEET_JOB}-serve-2"
        assert os.path.islink(os.path.join(logs, f"{new}.log")), "the warm spare was not adopted"
        maddr = {name: m for name, _s, m in ctl.replicas()}
        _check_fleet_replica(new, maddr[new], fresh=True)
        fc.set_replicas(addrs3)
        load = _FleetLoad(fc, one, FLEET_QPS).start()
        time.sleep(FLEET_LOAD_S)
        at3 = load.stop()
        for name, m in maddr.items():
            _check_fleet_replica(name, m)
        saddr = {name: s for name, s, _m in ctl.replicas()}
        bulk = _FleetLoad(fc, one, FLEET_BULK_QPS, lane="bulk").start()
        for _ in range(6):
            time.sleep(0.5)
            decisions.append(ctl.poll_once())
            if decisions[-1]["action"]:
                break
        assert decisions[-1]["action"] == "down", decisions
        t_down = time.perf_counter()
        # The victim is out of membership at once but its pod lives on.
        (victim,) = sorted(set(ctl.pods.live_pods()) - {n for n, _s, _m in ctl.replicas()})
        fc.set_replicas(ctl.ready_addresses())
        assert sorted(fc.addresses()) == addrs, fc.addresses()
        deadline = time.perf_counter() + 60.0
        while saddr[victim] in fc.inflight():  # the lingering channel's last request
            assert time.perf_counter() < deadline, fc.inflight()
            time.sleep(0.05)
        launches[victim] = _check_fleet_replica(victim, maddr[victim])["launches"]
        time.sleep(max(0.0, t_down + FLEET_AUTOSCALE["drain_s"] - time.perf_counter()))
        decisions.append(ctl.poll_once())  # the drain is over: the pod goes
        time.sleep(1.0)
        retire = bulk.stop()
        assert victim not in ctl.pods.live_pods() and ctl.pods.counts()["live"] == 2
        events = [(e["from"], e["to"]) for e in ctl.events()]
        assert events == [(2, 3), (3, 2)], events
        for lr in (at2, at3, retire):
            assert not lr["errors"] and lr["ok"] > 0, lr
        log(f"[fleet] (c) at {FLEET_QPS} Predicts/s of one sequence for {FLEET_LOAD_S:.0f} s: "
            + "; ".join(f"{n} replicas n={lr['ok']} p50 {lr['p50_ms']:.1f} ms p90 "
                        f"{lr['p90_ms']:.1f} ms p99 {lr['p99_ms']:.1f} ms max {lr['max_ms']:.1f} ms"
                        for n, lr in (("2", at2), ("3", at3)))
            + f"; up decision to 3 ready (warm spare adopted) {adopt_s:.2f} s; "
            f"retired {victim} under {retire['ok']} bulk requests, 0 errors; scale events "
            + json.dumps([{k: e[k] for k in ("from", "to", "slo", "shed_online")}
                          for e in ctl.events()]) + f"; on {card}")
        report.update(load_2=at2, load_3=at3, retire=retire, adopt_s=adopt_s,
                      decisions=decisions, scale_events=ctl.events())

        # (d) SIGKILL a replica under traffic; the pod manager relaunches it.
        killed = f"{FLEET_JOB}-serve-1"
        launches[killed] = _check_fleet_replica(killed, maddr[killed])["launches"]
        retries = gaugelib.default().counter("edl_rpc_retry_total",
                                             labels={"service": "serving.fleet"})
        retries0 = retries.value()
        load = _FleetLoad(fc, one, FLEET_KILL_QPS).start()
        # Its launches as late as can be read before the kill: forwards it
        # runs between this scrape and the SIGKILL (at most the requests
        # then in flight on it) are not counted.
        launches[killed] = _replica_numbers(maddr[killed])["launches"]
        deadline = time.perf_counter() + 60.0
        while not fc.inflight().get(saddr[killed]):  # kill it under a request
            assert time.perf_counter() < deadline, "no request reached the replica to kill"
            time.sleep(0.002)
        os.kill(backend.pid(killed), signal.SIGKILL)
        t_kill = time.perf_counter()
        ctl.wait_ready(2, timeout_s=300.0)
        kill_s = time.perf_counter() - t_kill
        time.sleep(2.0)
        under_kill = load.stop()
        under_kill["retries"] = retries.value() - retries0
        # The request in flight on the killed replica, at least, was retried.
        assert not under_kill["errors"] and under_kill["retries"] >= 1, under_kill
        relaunch = f"{killed}-r1"
        assert relaunch in ctl.pods.live_pods(), ctl.pods.live_pods()
        warm = os.path.islink(os.path.join(logs, f"{relaunch}.log"))
        log(f"[fleet] (d) SIGKILL of {killed} under {FLEET_KILL_QPS} Predicts/s: {under_kill['ok']} "
            f"requests, 0 errors, {int(under_kill['retries'])} retried on another replica "
            f"(p50 {under_kill['p50_ms']:.1f} ms, max {under_kill['max_ms']:.1f} ms); "
            f"relaunched as {relaunch} "
            f"({'warm spare' if warm else 'cold'}), SIGKILL to ready {kill_s:.2f} s; on {card}")
        report.update(kill_to_ready_s=kill_s, kill_load=under_kill, relaunch_warm=warm)

        # (e) A second controller over the same registry, the first not stopped.
        live = sorted(ctl.pods.live_pods())
        logs2 = os.path.join(out, "pods2")
        ctl2, backend2 = controller(logs2)
        t_adopt = time.perf_counter()
        ctl2.start(2)
        addrs2 = sorted(ctl2.wait_ready(2, timeout_s=60.0))
        adopt2_s = time.perf_counter() - t_adopt
        assert addrs2 == addrs and sorted(ctl2.pods.live_pods()) == live, (addrs2, live)
        # Nothing spawned: no pod and no spare wrote a log, and each pod is
        # the first controller's process.
        assert not os.path.isdir(logs2) or not os.listdir(logs2), os.listdir(logs2)
        assert backend2.standby_depth() == 0, backend2.standby_depth()
        assert {n: backend2.pid(n) for n in live} == {n: backend.pid(n) for n in live}, live
        fc2 = FleetServingClient(addrs2, rng=random.Random(17))
        clients.append(fc2)
        maddr = {name: m for name, _s, m in ctl2.replicas()}
        answers = _answer_everywhere(fc2, sorted(maddr.values()), one)
        assert all(np.array_equal(a, got["bucket1"][0]) for per in answers.values() for a in per)
        log(f"[fleet] (e) a second controller adopted {live} in {adopt2_s:.2f} s: same "
            f"addresses, nothing spawned; the adopted fleet answers as in (b)")
        report["restart_adopt_s"] = adopt2_s

        # (f) Per replica: launches = 12 x (flushes + warm forwards), buckets 1 and 2.
        final = {name: _check_fleet_replica(name, m) for name, m in maddr.items()}
        launches.update({name: f["launches"] for name, f in final.items()})
        log("[fleet] (f) per replica (flash launches, flushes by bucket, requests): " + "; ".join(
            f"{n} {int(f['launches'])} = {layers} x ({int(sum(f['flushes'].values()))} + "
            f"{FLEET_WARM_FORWARDS}), {json.dumps(f['flushes'])}, {int(f['served'])}"
            for n, f in sorted(final.items())))
        report["replicas"] = final
        report["flash_launches"] = int(sum(launches.values()))
    finally:
        for fc_ in clients:
            fc_.close()
        if ctl2 is not None:
            ctl2.stop()  # SIGTERMs the adopted replicas
        ctl.stop()  # the first controller's spare and anything left
    shutil.rmtree(ckpt)
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[fleet] phase 16 in {report['wall_s']:.1f} s; {report['flash_launches']} flash launches "
        f"over the fleet's replicas")
    return report


# ---- phase 17: the fused task dispatch ------------------------------------------

#: Steps a fused task: one stacked batch of FUSED_T minibatches a model.
FUSED_T = 8
FUSED_TIMED_TASKS = 2
#: The models at the widths of earlier phases: transformer_lm at phase 4's
#: (remat on: all three flash kernels inside the graph), MNIST, ResNet-50
#: and Wide&Deep at phase 14's, DeepFM at phase 10's (no host tier).
FUSED_MODELS = ("transformer_lm", "resnet50", "mnist", "deepfm", "wide_deep")
FUSED_BATCH = {"transformer_lm": TRAIN_BATCH, "resnet50": ZOO_BATCH["resnet50"],
               "mnist": ZOO_BATCH["mnist"], "deepfm": DFM_BATCH,
               "wide_deep": ZOO_BATCH["wide_deep"]}
#: Fused against per-step: bit for bit, except where a step sums with
#: atomics (the embedding backward's ``index_add_`` of DeepFM's and
#: Wide&Deep's tables): there the largest difference of an array over its
#: largest magnitude.  The convolutional models run these comparisons with
#: cuDNN's deterministic algorithms (``FUSED_DETERMINISTIC``): its default
#: convolution backward sums with atomics too, and MNIST's two eager runs
#: then differ in the last bit.  The times are taken in the default mode.
FUSED_REL = {"deepfm": 1e-6, "wide_deep": 1e-6}
FUSED_DETERMINISTIC = ("resnet50", "mnist")
FUSED_DEVICE = "cuda"


def _fused_setup(name: str, out: str):
    """(trainer, one host batch of the model's main-path feed)."""
    from elasticdl_tpu_torch.common.config import JobConfig
    from elasticdl_tpu_torch.data.reader import RecordIODataReader
    from elasticdl_tpu_torch.data.synthetic import synthetic_criteo
    from elasticdl_tpu_torch.models import deepfm, transformer_lm
    from elasticdl_tpu_torch.parallel.trainer import Trainer

    n = FUSED_BATCH[name]
    if name == "transformer_lm":
        spec = transformer_lm.model_spec(compute_dtype="bfloat16", remat=True, **TRAIN_WIDTH)
        toks = _planted_sequences(np.random.default_rng(7), n, TRAIN_WIDTH["seq_len"],
                                  TRAIN_WIDTH["vocab"])
        return Trainer(spec, device=FUSED_DEVICE), {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if name == "deepfm":
        spec = deepfm.model_spec(**DFM_WIDTH)
        path = synthetic_criteo(os.path.join(out, "criteo.rio"), n, seed=13,
                                container="recordio")
        reader = RecordIODataReader(path)
        batch = dict(spec.feed(reader.read_records_packed(reader.create_shards(n)[0])))
        os.remove(path)
        return Trainer(spec, device=FUSED_DEVICE), batch
    spec = _zoo_module(name).model_spec(**ZOO_WIDTH[name])
    [batch] = _zoo_batches(spec, _zoo_records(name, n, 4, out), n)
    return Trainer(spec, device=FUSED_DEVICE,
                   config=JobConfig(distribution_strategy=ZOO_STRATEGY[name])), dict(batch)


def _device_timeline(fn) -> dict:
    """One ``fn()`` under torch.profiler (the device alone): the kernels'
    summed time and count, the span from the first kernel's start to the
    last one's end, and the idle time between kernels in it, with the
    largest gaps and the kernels before them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False) and "#" not in e.name)
    busy = sum(end - start for start, end, _ in spans)
    gaps, reach, before = [], spans[0][1] if spans else 0, spans[0][2] if spans else ""
    for start, end, name in spans[1:]:
        if start > reach:
            gaps.append((start - reach, before[:60], name[:60]))
        if end > reach:
            reach, before = end, name
    gaps.sort(reverse=True)
    return {"device_ms": busy / 1e3, "kernels": len(spans),
            "span_ms": (reach - spans[0][0]) / 1e3 if spans else 0.0,
            "idle_ms": sum(g[0] for g in gaps) / 1e3, "gaps": len(gaps),
            "largest_gaps_us": [[round(g[0], 1), g[1], g[2]] for g in gaps[:4]]}


def _fused_diff(got: dict, want: dict) -> float:
    """The largest difference of any array over its largest magnitude (0.0:
    bit for bit)."""
    worst = 0.0
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        if not np.array_equal(g, w):
            worst = max(worst, float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)))
    return worst


def _fused_checks(trainer, stacked: dict):
    """(a)-(d) of phase 17 on one model: (readings, the launches of a
    replayed task, the state trained by then, the seconds of the task that
    captured)."""
    from elasticdl_tpu_torch.ops import kernels

    state = trainer.init_state(0)
    placed = trainer.shard_stacked_batch(stacked)
    steps = [{k: v[i] for k, v in placed.items()} for i in range(len(placed["labels"]))]
    readings = {}

    # (a) The variant's first task runs eagerly (the optimizer makes its
    # slots, the libraries their first-call work); the second captures the
    # T steps and replays them.
    state, _ = trainer.train_scan(state, placed)
    capture_task_s, state = _timed_task(trainer, state, placed)
    assert len(trainer.scan_graphs()) == 1
    start = trainer.host_state(state)

    # (b) A replay under sync debug mode "error" against the per-step loop
    # from the same state: losses, parameters, optimizer slots, launches.
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, fused = trainer.train_scan(state, placed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fused_counts = kernels.counts()
    fused_arrays = trainer.host_state(state)
    state = trainer.adopt_restored(start, state)
    kernels.reset_counts()
    state, per_step = trainer.run_train_steps(state, steps, pre_sharded=True)
    step_counts = kernels.counts()
    step_arrays = trainer.host_state(state)
    readings["train_losses"] = _fused_diff(
        {"loss": fused["loss"].float().cpu().numpy()},
        {"loss": torch.stack([m["loss"] for m in per_step]).float().cpu().numpy()})
    readings["train_state"] = _fused_diff(fused_arrays, step_arrays)
    assert fused_counts == step_counts, (fused_counts, step_counts)

    # (c) Restore, then fused: the restore replaces the optimizer's slots, so
    # the graph is dropped and captured anew on the live tensors; the task
    # must train the restored state (a stale graph would step dead slots).
    state = trainer.adopt_restored(start, state)
    state, restored = trainer.train_scan(state, placed)
    assert len(trainer.scan_graphs()) == 1
    readings["restore_then_fused"] = _fused_diff(trainer.host_state(state), step_arrays)
    readings["restore_then_fused_losses"] = _fused_diff(
        {"loss": restored["loss"].float().cpu().numpy()},
        {"loss": fused["loss"].float().cpu().numpy()})

    # (d) eval_scan: eager, captured, then a replay under "error", against
    # per-step eval on the same steps.
    for _ in range(2):
        trainer.eval_scan(state, placed)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev = trainer.eval_scan(state, placed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev_steps = [trainer.eval_step(state, b) for b in steps]
    readings["eval"] = _fused_diff({k: v.float().cpu().numpy() for k, v in ev.items()},
                                   {k: torch.stack([m[k] for m in ev_steps]).float().cpu().numpy()
                                    for k in ev})
    return readings, fused_counts, state, capture_task_s


def _timed_task(trainer, state, placed) -> tuple:
    """(seconds, state) of one ``train_scan`` task, the card settled on
    both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = trainer.train_scan(state, placed)
    torch.cuda.synchronize()
    return time.perf_counter() - t, state


def _fused_model(name: str, out: str, card: str) -> dict:
    from elasticdl_tpu_torch.parallel.trainer import ScanBudgetError, Trainer

    t_model = time.perf_counter()
    trainer, batch = _fused_setup(name, out)
    rows = len(batch["labels"])
    rng = np.random.default_rng(17)
    perms = [rng.permutation(rows) for _ in range(FUSED_T)]
    stacked = {k: np.stack([np.asarray(v)[p] for p in perms]) for k, v in batch.items()}
    limit = FUSED_REL.get(name, 0.0)
    # (a)-(d) compare bit for bit: cuDNN's deterministic algorithms for the
    # convolutional models (``FUSED_DETERMINISTIC``), its default after.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = name in FUSED_DETERMINISTIC
    try:
        readings, fused_counts, state, capture_task_s = _fused_checks(trainer, stacked)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if name in FUSED_DETERMINISTIC:
        # (e) and (f) in cuDNN's default mode, the worker's path, on a
        # trainer of its own: the trained state restored, its first task
        # eager, the second captured (its seconds kept).
        spec, config, trained = trainer.spec, trainer.config, trainer.host_state(state)
        del trainer, state
        torch.cuda.empty_cache()
        trainer = Trainer(spec, device=FUSED_DEVICE, config=config)
        state = trainer.adopt_restored(trained)
        placed = trainer.shard_stacked_batch(stacked)
        state, _ = trainer.train_scan(state, placed)
        capture_task_s, state = _timed_task(trainer, state, placed)
        steps = [{k: v[i] for k, v in placed.items()} for i in range(FUSED_T)]
        state, _ = trainer.run_train_steps(state, steps, pre_sharded=True)  # first-call work
        for _ in range(2):  # eval: eager, then captured
            trainer.eval_scan(state, placed)
    placed = trainer.shard_stacked_batch(stacked)
    steps = [{k: v[i] for k, v in placed.items()} for i in range(FUSED_T)]
    graph = next(g for g in trainer.scan_graphs() if g["kind"] == "train_scan")
    graphs = trainer.scan_graphs()

    # (e) Time: per-step and fused tasks in turns; the task's device span
    # (CUDA events) and its host enqueue, each over T; one task of each
    # under torch.profiler for the device-busy ms and kernels a step.
    def per_task():
        return trainer.run_train_steps(holder[0], steps, pre_sharded=True)[0]

    def fused_task():
        return trainer.train_scan(holder[0], placed)[0]

    holder = [state]
    timing = {"per_step": [], "fused": []}
    enqueue = {"per_step": [], "fused": []}
    for _ in range(FUSED_TIMED_TASKS):
        for arm, fn in (("per_step", per_task), ("fused", fused_task)):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            a.record()
            holder[0] = fn()
            b.record()
            enqueue[arm].append((time.perf_counter() - t) * 1e3 / FUSED_T)
            torch.cuda.synchronize()
            timing[arm].append(a.elapsed_time(b) / FUSED_T)
    busy = {}
    for arm, fn in (("per_step", per_task), ("fused", fused_task)):
        def one(fn=fn):
            holder[0] = fn()

        line = _device_timeline(one)
        busy[arm] = dict(line, **{k: line[k] / FUSED_T
                                  for k in ("device_ms", "kernels", "span_ms", "idle_ms")})

    # (f) The budget: three more step counts are variants 2-4 (each runs
    # eagerly, as a variant's first task); a fifth raises before running.
    state = holder[0]
    for t_ in (1, 2, 3):
        part = trainer.shard_stacked_batch({k: v[:t_] for k, v in stacked.items()})
        state, _ = trainer.train_scan(state, part)
    try:
        trainer.train_scan(state, trainer.shard_stacked_batch({k: v[:4] for k, v in stacked.items()}))
        raised = False
    except ScanBudgetError:
        raised = True
    result = {
        "batch": rows, "steps_a_task": FUSED_T, "readings": readings, "limit": limit,
        "checks_cudnn_deterministic": name in FUSED_DETERMINISTIC,
        "launches": fused_counts, "capture_s": graph["capture_s"],
        "capture_task_s": capture_task_s, "graph_pool_bytes": sum(g["pool_bytes"] for g in graphs),
        "graphs": [{k: g[k] for k in ("kind", "capture_s", "pool_bytes")} for g in graphs],
        "step_ms": {arm: statistics.median(v) for arm, v in timing.items()},
        "step_ms_all": timing, "enqueue_ms": {arm: statistics.median(v) for arm, v in enqueue.items()},
        "busy": busy, "fifth_variant_raised": raised, "wall_s": time.perf_counter() - t_model,
    }
    log(f"[fused] {name} B={rows}, T={FUSED_T}: fused vs per step: losses "
        f"{readings['train_losses']:.3g}, state {readings['train_state']:.3g}, restore-then-fused "
        f"{readings['restore_then_fused']:.3g}, eval {readings['eval']:.3g} (0 = bit for bit; "
        f"limit {limit}); launches a task {json.dumps(fused_counts)} on both paths")
    log(f"[fused] {name}: step {result['step_ms']['per_step']:.3f} ms per step vs "
        f"{result['step_ms']['fused']:.3f} ms fused (task span / T, CUDA events, p50 of "
        f"{FUSED_TIMED_TASKS}); host enqueue {result['enqueue_ms']['per_step']:.3f} vs "
        f"{result['enqueue_ms']['fused']:.3f} ms a step; device busy "
        f"{busy['per_step']['device_ms']:.3f} vs {busy['fused']['device_ms']:.3f} ms a step in "
        f"{busy['per_step']['kernels']:.0f} vs {busy['fused']['kernels']:.0f} kernels, idle "
        f"between kernels {busy['per_step']['idle_ms']:.3f} vs {busy['fused']['idle_ms']:.3f} ms "
        f"a step (profiled); capture "
        f"{graph['capture_s']:.2f} s (its task {capture_task_s:.2f} s), graph pool "
        f"{result['graph_pool_bytes'] / 2**20:.1f} MiB over {len(graphs)} graphs; fifth variant "
        f"raised: {raised}; {result['wall_s']:.1f} s on {card}")
    log(f"[fused] {name} largest idle gaps (us, kernel before, kernel after): fused "
        + json.dumps(busy["fused"]["largest_gaps_us"]) + "; per step "
        + json.dumps(busy["per_step"]["largest_gaps_us"]))
    del trainer, state, holder, placed, steps
    torch.cuda.empty_cache()
    return result


def phase_fused(card: str) -> dict:
    """Phase 17: the fused task dispatch (module docstring)."""
    import shutil

    from elasticdl_tpu_torch.ops import flash_attention as fa

    out = os.path.join(REPO, "chiprun_out", "fused")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    torch.cuda.empty_cache()
    report = {name: _fused_model(name, out, card) for name in FUSED_MODELS}
    bad = [(name, k, v) for name, r in report.items() for k, v in r["readings"].items()
           if v > r["limit"]]
    assert not bad, bad
    assert all(r["fifth_variant_raised"] for r in report.values())
    lm = report["transformer_lm"]["launches"]
    layers = TRAIN_WIDTH["n_layers"]
    # Remat: each layer's forward runs again in the backward.
    assert lm == {fa.KERNEL: 2 * layers * FUSED_T, fa.DQ_KERNEL: layers * FUSED_T,
                  fa.DKV_KERNEL: layers * FUSED_T}, lm
    report["launches"] = lm
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA card",
              file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    from elasticdl_tpu_torch.common.device import set_matmul_precision
    from elasticdl_tpu_torch.ops import flash_attention as fa

    set_matmul_precision()
    t0 = time.perf_counter()
    report = {"card": card, "device": torch.cuda.get_device_name(0), "phase_wall_s": {}}

    def run(key: str, fn, *args):
        t = time.perf_counter()
        report[key] = fn(*args)
        report["phase_wall_s"][key] = time.perf_counter() - t
        log(f"[wall] {key}: {report['phase_wall_s'][key]:.1f} s")
        return report[key]

    # The nvcc build (~70-100 s) runs beside phases 10 and 14, which launch
    # no hand-written kernel (each asserts it), so the script waits only
    # for what is left of it when they end.
    build = start_build()
    run("deepfm", phase_deepfm, card)
    run("zoo", phase_zoo, card)
    run("build", phase_build, build)
    run("kernel", phase_kernel_check)
    run("kernel_bwd", phase_kernel_check_bwd)
    run("train", phase_train_full_width, card)
    run("serve", phase_serve_full_width, card)
    run("grpc", phase_grpc_replica)
    run("job", phase_job, card, report["train"]["p50_step_ms"])
    run("process_job", phase_process_job, card, report["job"]["p50_step_ms"])
    run("process_job_standby", phase_process_job_standby, card,
        report["process_job"]["kill"]["recover_s"])
    run("gang1", phase_gang_world1, card, report["train"]["p50_step_ms"])
    run("gang2", phase_gang_pair, card)
    log(card)
    run("ps", phase_ps, card)
    run("opt_shard", phase_opt_shard, card)
    run("host_tier", phase_host_tier, card)
    run("ring_tp", phase_ring_tp, card)
    run("fleet", phase_fleet, card)
    run("fused", phase_fused, card)
    report["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    fwd, fwd_train = report["kernel"]["serve"], report["kernel"]["train"]
    bwd = report["kernel_bwd"]["train"]
    train_launches = report["train"]["launches"]
    job_launches = report["job"]["launches"]
    # The process-level jobs' last worker processes, the gang phases (the
    # world-1 trainer's run, the re-formed pair's processes and the sharded
    # optimizer's two ranks) and phase 17's replay of transformer_lm.
    proc_launches = {n: report["process_job"]["kernels"][n]
                     + report["process_job_standby"]["kernels"][n]
                     + report["gang1"]["launches"][n] + report["gang2"]["kernels"][n]
                     + report["opt_shard"]["launches"][n]
                     + report["fused"]["launches"][n]
                     for n in (fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)}
    source = "elasticdl_tpu_torch/csrc/"
    kernels_line = {"kernels": [
        {
            "name": fa.KERNEL, "route": "cuda", "source": source + fa.SOURCE,
            "replaces": "elasticdl_tpu/ops/flash_attention.py:72",
            # Launches on the main paths: serving flushes, training steps,
            # the job (train and eval steps, reload forwards), the
            # process-level jobs' last worker processes (train and eval
            # steps) and the serving fleet's replicas (flushes and warm
            # forwards, read from each replica's /metrics).
            "launches": (report["serve"]["flash_launches"] + train_launches[fa.KERNEL]
                         + job_launches[fa.KERNEL] + proc_launches[fa.KERNEL]
                         + report["fleet"]["flash_launches"]),
            "max_abs_err": fwd["kernel"]["o_max_abs"], "ms": fwd["ms"],
            "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
            "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
            # The same at the training path's shape (B=16).
            "train_ms": fwd_train["ms"], "train_library_ms": fwd_train["library_ms"],
            "train_bound_ms": fwd_train["bound_ms"],
        },
        {
            "name": fa.DQ_KERNEL, "route": "cuda", "source": source + fa.BWD_SOURCE,
            "replaces": "elasticdl_tpu/ops/flash_attention.py:87",
            "launches": (train_launches[fa.DQ_KERNEL] + job_launches[fa.DQ_KERNEL]
                         + proc_launches[fa.DQ_KERNEL]),
            "max_abs_err": bwd["kernel"]["dq"]["max_abs"], "ms": bwd["dq_ms"],
            "plain_ms": bwd["dq_plain_ms"], "bound_ms": bwd["dq_bound_ms"],
            "bound_by": bwd["dq_bound_by"], "library_ms": bwd["library_ms"],
        },
        {
            "name": fa.DKV_KERNEL, "route": "cuda", "source": source + fa.BWD_SOURCE,
            "replaces": "elasticdl_tpu/ops/flash_attention.py:108",
            "launches": (train_launches[fa.DKV_KERNEL] + job_launches[fa.DKV_KERNEL]
                         + proc_launches[fa.DKV_KERNEL]),
            "max_abs_err": max(bwd["kernel"]["dk"]["max_abs"], bwd["kernel"]["dv"]["max_abs"]),
            "ms": bwd["dkv_ms"], "plain_ms": bwd["dkv_plain_ms"],
            "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
            "library_ms": bwd["library_ms"],
        },
    ]}
    log(f"[done] all phases passed in {report['wall_s']:.1f}s")
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
