"""On-card smoke run of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``.  It drives the port (``elasticdl_tpu_torch``) and
never the JAX package, in phases; any failed phase raises and the script
exits non-zero without its result line:

1. build every kernel of the serving path from ``elasticdl_tpu_torch/csrc``
   (into ``elasticdl_tpu_torch/csrc/build/``, at first use);
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes and layout (q, k, v as views into the fused qkv
   projection), check that the limits reject a kernel that skips a tile,
   and time kernel, plain version and the library
   yardstick (``F.scaled_dot_product_attention``, timed here only: the port
   never calls it);
3. serve ``transformer_lm`` at the GPT-2-small width (vocab 32768, dim 768,
   12 heads, 12 layers, 1024 tokens) in process through the micro-batcher,
   with the kernel launch counts zeroed just before and read just after;
4. start a replica through ``serving/main.py`` in a subprocess (zoo-default
   width, 128 tokens) and answer gRPC Predict and ModelInfo with the wire
   sanitizer armed.

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
# Kernel against plain version, per dtype: O's error norm over O's norm
# ("o_rel"), O's largest element error over O's largest element ("o_max"),
# and lse's largest absolute error ("lse").  Set from the kernel's readings
# on the card (bf16 O within one output ulp, lse to f32 summation order) with
# room on both sides: every case also computes what a kernel that skipped
# one 64-key tile would give, and each limit must reject that reading.
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
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, l, h, d, dtype, causal) -> tuple:
    """(bound ms, what bounds it) for one attention forward: q, k, v read
    once, o and the f32 lse written once; 4*D flops per (query, key) pair
    the inputs need (causal: the L(L+1)/2 pairs on or below the diagonal)."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * l * h * d * elt + b * h * l * 4
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 4 * d * b * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> dict:
    from elasticdl_tpu_torch.ops import flash_attention, kernels

    t0 = time.perf_counter()
    kernels.load(flash_attention.SOURCE)
    wall = time.perf_counter() - t0
    seconds, build_log = kernels.build_info(flash_attention.SOURCE)
    log(f"[build] {flash_attention.SOURCE}: nvcc {seconds:.2f}s (load {wall:.2f}s)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build]   {line.strip()}")
    return {"source": flash_attention.SOURCE, "nvcc_s": seconds, "load_s": wall}


def _plain_skipping_a_tile(q, k, v, causal):
    """The plain version's arithmetic with the first 64-key tile masked for
    every query row past it: what a kernel that skipped that tile would
    give.  A wrong reading each limit in TOL must reject."""
    b, l, h, d = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * d**-0.5
    keep = torch.ones(l, l, dtype=torch.bool, device=q.device)
    keep[64:, :64] = False
    if causal:
        keep &= torch.ones_like(keep).tril()
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
        wrong = _readings(*_plain_skipping_a_tile(q, k, v, causal), ref, ref_lse)
        row = {"shape": [b, l, h, d], "dtype": str(dtype).split(".")[-1], "causal": causal,
               "input_scale": scale, "fused_qkv_views": fused, "tol": tol,
               "kernel": got, "tile_skipped": wrong}
        log(f"[kernel] flash_attention_fwd {name}: kernel {json.dumps(got)}; "
            f"one tile skipped {json.dumps(wrong)}; limits {json.dumps(tol)}")
        for key, limit in tol.items():
            assert got[key] <= limit, f"{name}: kernel {key} {got[key]:.3g} over {limit:.3g}"
            assert wrong[key] > limit, (
                f"{name}: limit {key} {limit:.3g} does not reject a skipped tile "
                f"({wrong[key]:.3g})")
        if (b, l) == (B, L) and scale == 0.5:
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


def _count(name: str) -> int:
    from elasticdl_tpu_torch.ops import kernels

    return kernels.counts().get(name, 0)


def _device_breakdown(fn) -> dict:
    """Device time of one ``fn()`` from torch.profiler's CUDA trace, summed
    by kernel and grouped: the flash kernel, matmuls, everything else."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms in by_kernel.items():
        k = key.lower()
        if "fwd_bf16_kernel" in k or "fwd_f32_kernel" in k:
            groups["flash"] += ms
        elif any(m in k for m in ("nvjet", "gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
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
    report["serve"] = phase_serve_full_width(card)
    report["grpc"] = phase_grpc_replica()
    report["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    main_case = report["kernel"]["serve"]
    kernels_line = {"kernels": [{
        "name": fa.KERNEL,
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:72",
        "launches": report["serve"]["flash_launches"],
        "max_abs_err": main_case["kernel"]["o_max_abs"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}
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
