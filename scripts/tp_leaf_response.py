#!/usr/bin/env python3
"""Phase 3m's per-leaf response, leaf by leaf, on one H100: full-width
rwkv6-1.6b (f32 weights from seed 0), one static (1, 1) round of replicas
(1, 2, 2) at ``chip_smoke.py``'s phase 3g (e) settings, with bf16 and with
f32 activations: on one device through ``wkv_chunked`` (the reference
round) and through ``wkv_scan`` (another summation order), and split over
4 gloo tp ranks sharing the card (``chip_smoke._tp_rank``, phase 3m).

    python3 scripts/tp_leaf_response.py

Run from the root of a checkout on a host with one NVIDIA H100. For each
activation dtype it prints each round's wall and replica 0's loss, the
mean and spread of the update of ``layers/tmix/ln_b`` (zero at init), and
for ``wkv_scan`` and the tp round against ``wkv_chunked`` the loss's
relative change and the leaves with the largest relative change of the
sum of squares and of the sum over L1 (``chip_smoke._replica_rel``).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
TOP = 5


def _top(got, ref, names) -> str:
    """The ``TOP`` leaves by each of ``_replica_rel``'s per-leaf
    measures."""
    pairs = list(zip(got["stats"], ref["stats"]))
    sq = [abs(a[2] - b[2]) / b[2] for a, b in pairs]
    sm = [abs(a[0] - b[0]) / b[1] for a, b in pairs]
    return "\n".join(
        f"      {label}: " + ", ".join(f"{names[i]} {v[i]:.3e}" for i in
                                       np.argsort(v)[::-1][:TOP])
        for label, v in (("sum of squares", sq), ("sum over L1", sm)))


def _tp_rank(rank, world, port, outdir, act):
    """``chip_smoke._tp_rank`` of phase 3m with ``act`` activations."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    cs.TP_RUNS["3m"] = dict(cs.TP_RUNS["3m"], cfg=dict(activ_dtype=act))
    cs._tp_rank(rank, world, port, outdir, "3m")


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    if not torch.cuda.is_available():
        print("tp_leaf_response: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    hm = mesh_lib.make_hfl_mesh(cs.TRAIN_REPS, device=dev)
    for act in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get_config("rwkv6-1.6b"),
                                  activ_dtype=act)
        model = model_mod.build_model(cfg)
        batch = token_batch(0, 8, 128, cfg.vocab, device=dev)
        evalb = token_batch(9999, 8, 128, cfg.vocab, device=dev)
        res = {}
        for route, chunked in (("wkv_chunked", True), ("wkv_scan", False)):
            p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
            params = train.lift_params(p1, *cs.TRAIN_REPS)
            del p1
            step, _, _ = train.make_hfl_train_step(
                cfg, hm, g1=1, g2=1, wkv_chunked=chunked,
                **dict(cs.TRAIN_KW, attn_chunk=128))
            params, wall, _ = cs._full_round(torch, ops, train, step, params,
                                             batch)
            with torch.no_grad():
                loss = float(model.loss(train._map(lambda a: a[0, 0, 0],
                                                   params), evalb,
                                        wkv_chunked=True))
            flat = cs._flat(params)
            ln_b = flat["layers/tmix/ln_b"][0, 0, 0].double()
            res[route] = {"loss": loss, "names": list(flat),
                          "stats": [cs._leaf_stats(torch, a[0, 0, 0])
                                    for a in flat.values()]}
            print(f"{act} activations, one device, {route}: round "
                  f"{wall:.3f} s, loss {loss:.6f}; ln_b's update: mean "
                  f"{float(ln_b.mean()):.4e}, std {float(ln_b.std()):.4e}",
                  flush=True)
            del params, flat, ln_b
            torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
        try:
            mp.spawn(_tp_rank, args=(cs.TP_WORLD, cs._free_port(), tmp, act),
                     nprocs=cs.TP_WORLD, join=True)
            res["tp"] = torch.load(os.path.join(tmp, "rank0.pt"),
                                   weights_only=False)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"{act} activations, {cs.TP_WORLD} tp ranks, wkv_chunked: "
              f"round {res['tp']['wall']:.3f} s, loss "
              f"{res['tp']['loss']:.6f}", flush=True)
        ref = res["wkv_chunked"]
        for label in ("wkv_scan", "tp"):
            rel = cs._replica_rel(res[label], ref)
            print(f"  {label} vs wkv_chunked: loss {rel[0]:.3e}, largest "
                  f"per-leaf sum of squares {rel[1]:.3e}, sum over L1 "
                  f"{rel[2]:.3e}\n" + _top(res[label], ref, ref["names"]),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
