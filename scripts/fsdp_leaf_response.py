#!/usr/bin/env python3
"""Phase 3n's per-leaf response, leaf by leaf: full-width whisper-base
(f32 weights from seed 0), one static (1, 1) round of replicas (1, 2, 2)
at ``chip_smoke.py``'s phase 3g (f) settings on one device with bf16
activations (the reference round), in KV chunks of 512 (3g (f'), another
summation order) and with f32 activations, then split over 2 gloo fsdp
ranks (``chip_smoke._fsdp_rounds``, phase 3n) in a fresh 2-rank world.

    python3 scripts/fsdp_leaf_response.py          # one NVIDIA H100
    python3 scripts/fsdp_leaf_response.py --cpu    # rehearsal, reduced

Run from the root of a checkout. On the card it first holds both kernels
at whisper's two new shapes (``chip_smoke._edge_mean_check``). It prints
each round's line as ``chip_smoke.py`` does, the fsdp rounds' responses
against the one-device rounds (``chip_smoke._replica_rel``), the leaves
with the largest relative change of the sum of squares (and their sum
over L1), and ``chip_smoke.fsdp_plane``'s checks. ``--cpu`` rehearses
the same code on the CPU at reduced whisper-base (2 + 2 layers, d_model
256, vocab 515 so that the guard keeps the vocabulary whole, 128 decoder
positions), counting the aggregation wrappers' calls as launches; the
card's timers and memory readings read 0 there.
"""
import argparse
import dataclasses
import os
import shutil
import socket
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
TOP = 5


def _cpu_rehearsal() -> None:
    """Reduced whisper-base on the CPU: the card's timers and memory
    readings stubbed, every mesh on the CPU, and the aggregation
    wrappers' calls counted in ``LAUNCHES`` as their launches would be."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import hier_agg
    from repro_torch.launch import mesh
    if getattr(configs, "_rehearsal", False):
        return
    configs._rehearsal = True
    torch.set_num_threads(1)
    for name in ("empty_cache", "reset_peak_memory_stats", "synchronize"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    whole = configs.get_config
    configs.get_config = lambda name: dataclasses.replace(
        whole(name).reduce(), dec_ctx=128, vocab=515)
    make = mesh.make_hfl_mesh
    mesh.make_hfl_mesh = lambda *a, **k: make(*a, **dict(k, device="cpu"))
    for name in ("segment_agg", "segment_sum_partial", "segment_broadcast"):
        key = "segment_broadcast" if name == "segment_broadcast" else \
            "segment_agg"

        def counted(*a, _fn=getattr(hier_agg, name), _key=key, **k):
            hier_agg.LAUNCHES[_key] += 1
            return _fn(*a, **k)
        setattr(hier_agg, name, counted)


def _rank(rank: int, world: int, port: int, outdir: str, cpu: bool):
    """One fsdp rank: phase 3n's rounds (``chip_smoke._fsdp_rounds``)."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    if cpu:
        _cpu_rehearsal()
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        torch.save(cs._fsdp_rounds(torch, dist, ops, configs, model_mod,
                                   train, mesh_lib),
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _top(got, ref) -> str:
    """The ``TOP`` leaves by the relative change of the sum of squares,
    with their sum over L1 (``chip_smoke._replica_rel``'s measures)."""
    pairs = list(zip(got["stats"], ref["stats"]))
    sq = [abs(a[2] - b[2]) / b[2] for a, b in pairs]
    sm = [abs(a[0] - b[0]) / b[1] for a, b in pairs]
    return ", ".join(f"{ref['names'][i]} {sq[i]:.3e} ({sm[i]:.3e})"
                     for i in np.argsort(sq)[::-1][:TOP])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse at reduced size on the CPU")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    if args.cpu:
        _cpu_rehearsal()
    elif not torch.cuda.is_available():
        print("fsdp_leaf_response: no CUDA device; pass --cpu to rehearse",
              file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    dev = "cpu" if args.cpu else torch.device("cuda", 0)
    if not args.cpu:
        for shape, seed in ((cs.WHISPER_AGG, 9), (cs.WHISPER_FT, 11)):
            cs._edge_mean_check(torch, ops, ref, dev, shape, seed)
    one = cs.whisper_rounds(torch, ops, configs, model_mod, train, mesh_lib,
                            dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="fsdp_leaf_response_",
                           dir=os.path.join(ROOT, "build"))
    try:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(_rank, args=(cs.FSDP_WORLD, port, out, args.cpu),
                 nprocs=cs.FSDP_WORLD, join=True)
        res = [torch.load(os.path.join(out, f"rank{r}.pt"),
                          weights_only=False) for r in range(cs.FSDP_WORLD)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for act, want in (("bfloat16", one), ("float32", one["f32"])):
        got = res[0][act]
        print(f"  fsdp {act} vs one device: loss, sums of squares, sums "
              f"over L1 {cs._replica_rel(got, want)}; largest: "
              f"{_top(got, want)}")
    print(f"  (f') vs (f): {one['reorder_rel']}")
    try:
        cs.fsdp_plane(torch, res, {"whisper": one}, 0.0)
    except RuntimeError as err:     # reduced: 32 frames, so (f') = (f)
        print(f"  {err}")
        return 0 if args.cpu else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
