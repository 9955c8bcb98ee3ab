"""On-card smoke run of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``.  It drives the port (``elasticdl_tpu_torch``) and
never the JAX package, in phases; any failed phase raises and the script
exits non-zero without its result line:

1. build every kernel source from ``elasticdl_tpu_torch/csrc`` at once (one
   nvcc each, into ``elasticdl_tpu_torch/csrc/build/``, at first use) and
   report each bf16 kernel's registers, shared memory, spills and blocks
   per SM (forward, dq, dkv; D=64 and D=128);
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
   train step matches the live state's.

Prints the card's name and power limit first, a ``{"kernels": [...]}``
line before the last, and ``{"ok": true, "device": {...}}`` last.  The
numbers also go to ``chiprun_out/chip_smoke.json``.
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


def phase_build() -> dict:
    """Build every kernel source at once (one nvcc per source, each in its
    own thread: the builds hold per-source locks) and log each source's
    nvcc seconds, registers and spills, and the bf16 kernels' shared
    memory and blocks per SM."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticdl_tpu_torch.ops import flash_attention, kernels

    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(kernels.load, sources))
    wall = time.perf_counter() - t0
    report = {"wall_s": wall, "sources": {}}
    for source in sources:
        seconds, build_log = kernels.build_info(source)
        log(f"[build] {source}: nvcc {seconds:.2f}s")
        for line in build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
                log(f"[build]   {line.strip()}")
        report["sources"][source] = {"nvcc_s": seconds}
    log(f"[build] {len(sources)} sources built concurrently in {wall:.2f}s")
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
    and after each one: the step time as the device sees it, gaps between
    steps included."""
    events = []
    step = trainer.train_step

    def timed_step(state, batch):
        if not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        result = step(state, batch)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return result

    trainer.train_step = timed_step
    return events


def _event_intervals_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


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
    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    report["build"] = phase_build()
    report["kernel"] = phase_kernel_check()
    report["kernel_bwd"] = phase_kernel_check_bwd()
    report["train"] = phase_train_full_width(card)
    report["serve"] = phase_serve_full_width(card)
    report["grpc"] = phase_grpc_replica()
    report["job"] = phase_job(card, report["train"]["p50_step_ms"])
    report["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    fwd, fwd_train = report["kernel"]["serve"], report["kernel"]["train"]
    bwd = report["kernel_bwd"]["train"]
    train_launches = report["train"]["launches"]
    job_launches = report["job"]["launches"]
    source = "elasticdl_tpu_torch/csrc/"
    kernels_line = {"kernels": [
        {
            "name": fa.KERNEL, "route": "cuda", "source": source + fa.SOURCE,
            "replaces": "elasticdl_tpu/ops/flash_attention.py:72",
            # Launches on the main paths: serving flushes, training steps,
            # and the job (train and eval steps, reload forwards).
            "launches": (report["serve"]["flash_launches"] + train_launches[fa.KERNEL]
                         + job_launches[fa.KERNEL]),
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
            "launches": train_launches[fa.DQ_KERNEL] + job_launches[fa.DQ_KERNEL],
            "max_abs_err": bwd["kernel"]["dq"]["max_abs"], "ms": bwd["dq_ms"],
            "plain_ms": bwd["dq_plain_ms"], "bound_ms": bwd["dq_bound_ms"],
            "bound_by": bwd["dq_bound_by"], "library_ms": bwd["library_ms"],
        },
        {
            "name": fa.DKV_KERNEL, "route": "cuda", "source": source + fa.BWD_SOURCE,
            "replaces": "elasticdl_tpu/ops/flash_attention.py:108",
            "launches": train_launches[fa.DKV_KERNEL] + job_launches[fa.DKV_KERNEL],
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
