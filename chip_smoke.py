#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, all at once);
2. hold each kernel against its plain PyTorch version on the card, on the
   same tensors, at the main path's shapes (MNIST and CIFAR banks, Eq. 1
   with 5 edges and Eq. 2 with 1) in f32 and with a bf16 bank, plus a
   ragged case with an empty segment: ``segment_agg`` within atol = rtol
   = 1e-5 (the kernel sums rows in order with fmaf, the plain version
   with ``index_add_``; the orders differ), ``segment_broadcast``
   bitwise, and two runs of each kernel bitwise equal;
3. a small cloud round on the card against the same round on the CPU
   (plain versions), then the main path: ``HFLEnv`` in real mode at the
   paper's CIFAR defaults (50 devices, 5 edges, 1000 samples each,
   batch 32, gamma_max 8) -- reset, two ``step_raw(2, 2)`` and one
   ``step`` with a seeded random action -- with the launch counts of
   both kernels read around it and held to what the round's loop
   implies; then the same at the MNIST defaults;
4. kernel times at the main path's shapes (CIFAR and MNIST, Eq. 1 with
   its resync and Eq. 2): device time per launch from CUDA events around
   a CUDA-graph replay, beside the plain version's, one PyTorch library
   call's, the bound (bytes over 3.35 TB/s), and the eager wrapper's
   time per call as the round pays it (host dispatch included).

It prints the card's name and power limit, then one JSON line of the
kernels, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
KERNEL_SRC = "src/repro_torch/kernels/csrc/hier_agg.cu"
REPLACES = {"segment_agg": "src/repro/kernels/hier_agg.py:84",
            "segment_broadcast": "src/repro/kernels/hier_agg.py:194"}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
AGG_TOL = 1e-5                  # segment_agg vs plain: summation order


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_time(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def event_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``iters``
    back-to-back eager calls, after ``warmup`` calls. For a short kernel
    this is the host's dispatch time, not the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int = 50) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, timed with CUDA events around a replay, so no host dispatch
    sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

CASES = [("mnist-eq1", 50, 21840, 5), ("mnist-eq2", 5, 21840, 1),
         ("cifar-eq1", 50, 456906, 5), ("cifar-eq2", 5, 456906, 1),
         ("ragged-empty", 9, 997, 4)]


def kernel_checks(torch, ops, ref, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"segment_agg": 0.0, "segment_broadcast": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, p, e in CASES:
            bank = torch.randn((n, p), generator=gen, device=dev).to(dtype)
            w = torch.rand((n,), generator=gen, device=dev) * 2.9 + 0.1
            seg = torch.randint(0, e, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            if name.startswith("ragged"):
                seg[seg == 2] = 0                  # segment 2 is empty
            got = ops.segment_agg(bank, w, seg, e)
            want = ref.segment_agg_ref(bank, w, seg, e)
            d = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=AGG_TOL, rtol=AGG_TOL),
                  f"segment_agg {name} {dtype}: max abs err {d}")
            check(torch.equal(got, ops.segment_agg(bank, w, seg, e)),
                  f"segment_agg {name} {dtype}: two runs differ")
            if name.startswith("ragged"):
                check(int(torch.count_nonzero(got[2])) == 0,
                      "segment_agg: empty segment is not zero")
            sums, wsum = ops.segment_sum_partial(bank, w, seg, e)
            want_s = ref.segment_scaled_sum_ref(bank, w, seg,
                                                torch.ones_like(wsum), e)
            check(torch.allclose(sums, want_s, atol=AGG_TOL, rtol=AGG_TOL),
                  f"segment_sum_partial {name} {dtype}")
            err["segment_agg"] = max(err["segment_agg"], d)

            models = torch.randn((e, p), generator=gen, device=dev)
            out = ops.segment_broadcast(models, seg, out_dtype=dtype)
            want_b = ref.segment_broadcast_ref(models, seg, dtype)
            check(out.dtype == dtype and torch.equal(out, want_b),
                  f"segment_broadcast {name} {dtype}: not bitwise equal")
            again = ops.segment_broadcast(models, seg, out_dtype=dtype)
            check(torch.equal(out, again),
                  f"segment_broadcast {name} {dtype}: two runs differ")
            print(f"  {name:13s} {str(dtype):15s} N={n:3d} P={p:7d} E={e}"
                  f"  segment_agg max|err| {d:.3e}  broadcast bitwise")
    return err


# ---------------------------------------------------------------------------
# phase 3: a small round against the CPU, then the main path
# ---------------------------------------------------------------------------

def small_round_check(torch, hfl, model, dev) -> None:
    """One cloud round of the MNIST CNN (6 devices, 2 edges, 64 samples)
    on the card and on the CPU from the same bank, data and shuffles."""
    n, m, n_local = 6, 2, 64
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, n_local, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (n, n_local)).astype(np.int32))
    perms = torch.from_numpy(np.stack([
        np.stack([np.stack([rng.permutation(n_local) for _ in range(n)])
                  for _ in range(2)]) for _ in range(2)]))
    ea = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32)
    g1, g2 = np.array([2, 1]), np.array([1, 2])
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_cloud_round(loss, 0.05, 32, m, 2, 2)
    outs = []
    for d in ("cpu", dev):
        bank = hfl.init_bank(model.mnist_cnn_init,
                             torch.Generator().manual_seed(7), n,
                             device="cpu")
        bank = {k: v.to(d) for k, v in bank.items()}
        sizes = torch.full((n,), float(n_local), device=d)
        outs.append(rnd(bank, x.to(d), y.to(d), sizes, ea.to(d), g1, g2,
                        perms.to(d)))
    errs = []
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            a, b = cpu_part[k], gpu_part[k].cpu()
            errs.append(float((a - b).abs().max()))
            check(torch.allclose(b, a, rtol=1e-4, atol=1e-5),
                  f"small round: {k} differs between CPU and GPU")
    print(f"  small MNIST round (6 dev, 2 edges): GPU vs CPU max|err| "
          f"{max(errs):.3e} (tolerance rtol 1e-4, atol 1e-5)")


def expected_launches(rounds, gamma_max: int) -> dict:
    """Launches the cloud round's loop implies: per round one
    segment_agg for the starting edge models, one segment_agg and one
    segment_broadcast per executed t2 step, one segment_agg for Eq. 2."""
    agg = bcast = 0
    for _, g2 in rounds:
        steps = min(gamma_max, int(np.max(g2)))
        agg += 2 + steps
        bcast += steps
    return {"segment_agg": agg, "segment_broadcast": bcast}


def main_path(torch, ops, env_mod, task: str, dev) -> dict:
    cfg = env_mod.EnvConfig(task=task, mode="real")
    t0 = time.perf_counter()
    env = env_mod.HFLEnv(cfg)
    t_setup = sync_time(torch) - t0
    c = env.cfg
    check(env.fed.x.is_cuda and env.device.type == "cuda",
          "the env's data is not on the card")
    m, gmax = c.n_edges, c.gamma_max
    rounds = [(np.full(m, 2), np.full(m, 2))]          # reset's warmup
    print(f"  {task}: {c.n_devices} devices, {m} edges, n_local "
          f"{c.n_local}, batch {c.batch_size}, gamma_max {gmax}, lr {c.lr};"
          f" setup {t_setup:.2f} s")
    ops.reset_launches()
    t0 = time.perf_counter()
    state = env.reset()
    t1 = sync_time(torch)
    print(f"    reset     acc {env.acc:.4f}  wall {t1 - t0:.3f} s")
    results = []
    for i in range(2):
        g = np.full(m, 2)
        rounds.append((g, g))
        t0 = time.perf_counter()
        state, r, _, info = env.step_raw(g, g)
        t1 = sync_time(torch)
        results.append((info, r, t1 - t0))
        print(f"    step_raw  acc {info['acc']:.4f}  reward {r:+.4f}  "
              f"energy {info['energy']:.2f}  wall {t1 - t0:.3f} s")
    action = np.random.default_rng(0).uniform(1, gmax, size=2 * m)
    a = np.clip(np.round(action), 1, gmax).astype(np.int64)
    rounds.append((a[:m], a[m:]))
    t0 = time.perf_counter()
    state, r, _, info = env.step(action)
    t1 = sync_time(torch)
    results.append((info, r, t1 - t0))
    print(f"    step      acc {info['acc']:.4f}  reward {r:+.4f}  energy "
          f"{info['energy']:.2f}  wall {t1 - t0:.3f} s  g1 {a[:m]} "
          f"g2 {a[m:]}")
    counts = dict(ops.LAUNCHES)
    want = expected_launches(rounds, gmax)
    print(f"    launches {counts} (expected {want})")
    check(counts == want, f"{task}: launch counts {counts} != {want}")
    check(all(v > 0 for v in counts.values()),
          f"{task}: a kernel was not launched on the main path")
    check(state.shape == env.state_shape and np.isfinite(state).all(),
          f"{task}: bad state {state.shape}")
    for info, r, _ in results:
        check(0.0 <= info["acc"] <= 1.0 and np.isfinite(r)
              and np.isfinite(info["energy"]), f"{task}: bad step {info}")
    for k, v in env.bank.items():
        check(v.is_cuda and bool(torch.isfinite(v).all()),
              f"{task}: bank leaf {k} not finite on the card")
        check(torch.equal(v, env.global_model[k].expand_as(v)),
              f"{task}: bank rows not synced to the global model")
    return {"counts": counts, "rounds": len(rounds)}


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

# shapes the main path gives the kernels: Eq. 1 (and the resync) at
# (N, E) = (50, 5), Eq. 2 at (5, 1); the JSON line reports CIFAR Eq. 1
TIMED = [("cifar-eq1", 50, 456906, 5), ("cifar-eq2", 5, 456906, 1),
         ("mnist-eq1", 50, 21840, 5), ("mnist-eq2", 5, 21840, 1)]


def time_shape(torch, hier_agg, ops, ref, dev, n: int, p: int,
               e: int) -> dict:
    """Times of each kernel at one shape: kernel, plain version and one
    PyTorch library call computing the same function, plus the bound.
    The resync runs only where devices sync from edges (E > 1)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bank = torch.randn((n, p), generator=gen, device=dev)
    w = torch.full((n,), 1000.0, device=dev)
    seg = (torch.arange(n, device=dev) % e).to(torch.int32)
    inv = 1.0 / ref.segment_weight_sums(w, seg, e).clamp_min(1e-9)
    onehot = (seg[None, :].long() == torch.arange(e, device=dev)[:, None])
    a_mat = onehot.float() * w[None, :] * inv[:, None]      # (E, N)
    models = torch.randn((e, p), generator=gen, device=dev)
    out = torch.empty((n, p), device=dev)
    seg64 = seg.long()

    def agg_kernel():
        return hier_agg._launch_segment_agg(bank, w, seg, inv, e)

    check(torch.allclose(torch.mm(a_mat, bank), agg_kernel(), atol=AGG_TOL,
                         rtol=AGG_TOL), "library yardstick disagrees")
    cases = [("segment_agg", agg_kernel,
              lambda: ops.segment_agg(bank, w, seg, e),
              lambda: ref.segment_scaled_sum_ref(bank, w, seg, inv, e),
              lambda: torch.mm(a_mat, bank),
              4 * (n * p + e * p + 2 * n + e), 2 * n * p)]
    if e > 1:
        bcast = lambda: ops.segment_broadcast(models, seg, out=out)
        cases.append(("segment_broadcast", bcast, bcast,
                      lambda: ref.segment_broadcast_ref(models, seg),
                      lambda: torch.index_select(models, 0, seg64),
                      4 * (e * p + n * p + n), 0))
    res = {}
    before = dict(hier_agg.LAUNCHES)
    for name, kern, call, plain, lib, nbytes, flops in cases:
        t_call = event_ms(torch, call)
        t_plain1 = graph_ms(torch, plain)
        t_k1 = graph_ms(torch, kern)
        t_k2 = graph_ms(torch, kern)
        t_plain2 = graph_ms(torch, plain)
        t_lib = graph_ms(torch, lib)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        ms = min(t_k1, t_k2)
        res[name] = {"ms": ms, "plain_ms": min(t_plain1, t_plain2),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": t_lib,
                     "call_ms": t_call}
        print(f"  {name:17s} N={n:2d} E={e} P={p:6d}: kernel {t_k1:.4f}/"
              f"{t_k2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, "
              f"library {t_lib:.4f} ms, eager wrapper call {t_call:.4f} "
              f"ms, {nbytes / 1e6:.2f} MB, bound "
              f"{res[name]['bound_ms'] * 1e3:.2f} us "
              f"({res[name]['bound_ms'] / ms * 100:.1f}% of bound)")
    hier_agg.LAUNCHES.update(before)         # timing launches do not count
    return res


def timings(torch, hier_agg, ops, ref, dev, counts: dict, err: dict):
    """Time every main-path shape; returns the JSON rows (CIFAR Eq. 1
    and its resync)."""
    per_shape = {name: time_shape(torch, hier_agg, ops, ref, dev, n, p, e)
                 for name, n, p, e in TIMED}
    return [dict(name=k, route="cuda", source=KERNEL_SRC,
                 replaces=REPLACES[k], launches=counts[k],
                 max_abs_err=err[k], **per_shape["cifar-eq1"][k])
            for k in ("segment_agg", "segment_broadcast")]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.core import hfl
    from repro_torch.kernels import _build, hier_agg, ops, ref
    from repro_torch.models import model
    from repro_torch.sim import env as env_mod

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t_build = _build.build_all()
    for name, log in sorted(_build.BUILD_LOGS.items()):
        print(f"  nvcc {name}.cu:\n    " + "\n    ".join(
            ln for ln in log.strip().splitlines() if ln.strip()))
    lib_t0 = time.perf_counter()
    hier_agg._lib()
    print(f"  built in {t_build:.2f} s, loaded in "
          f"{time.perf_counter() - lib_t0:.3f} s")

    print("phase 2: kernels against their plain versions (atol=rtol=1e-5 "
          "for segment_agg, bitwise for segment_broadcast)")
    err = kernel_checks(torch, ops, ref, dev)

    print("phase 3: the main path")
    small_round_check(torch, hfl, model, dev)
    runs = {task: main_path(torch, ops, env_mod, task, dev)
            for task in ("cifar", "mnist")}

    print("phase 4: times per call, CUDA events around a CUDA-graph "
          "replay of 50 calls (kernel and plain each twice, in turns); "
          "the eager wrapper call is 50 back-to-back calls")
    rows = timings(torch, hier_agg, ops, ref, dev, runs["cifar"]["counts"],
                   err)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
