#!/usr/bin/env python3
"""Phase 3l of ``chip_smoke.py`` twice on one H100: with the port's split
products (``repro_torch.models.tp.column``/``row``: f32 partials summed
over the tp group, rounded once) and with plain Megatron ones (*f* before
each column product, *g* summing the bf16 partial products of each row
product), each held against phase 3g (b)'s one-device round.

    python3 scripts/tp_plain_products.py

Run from the root of a checkout on a host with one NVIDIA H100. It prints
the card's name and power limit, 3g (b)'s loss, and phase 3l's line for
each variant (round wall, gloo calls and seconds, loss and per-leaf sums
against 3g (b)'s). Phase 3l's own loss check is reported, not fatal:
the plain variant is expected to miss it.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def plain_rank(rank, world, port, outdir, phase):
    """``chip_smoke._tp_rank`` with the plain products when
    ``TP_PLAIN`` is 1."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from repro_torch.models import tp
    if os.environ.get("TP_PLAIN") == "1":
        tp.column = lambda x, ws, ctx: tuple(tp.copy_to(x, ctx) @ w
                                             for w in ws)
        tp.row = lambda x, w, ctx: tp.reduce_from(x @ w, ctx)
    import chip_smoke
    chip_smoke._tp_rank(rank, world, port, outdir, phase)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data.synthetic import token_batch
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    if not torch.cuda.is_available():
        print("tp_plain_products: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    disable_tf32()
    dev = torch.device("cuda", 0)
    cfg = configs.get_config("qwen3-1.7b")
    model = model_mod.build_model(cfg)
    hm = mesh_lib.make_hfl_mesh(cs.TRAIN_REPS, device=dev)
    p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    params = train.lift_params(p1, *cs.TRAIN_REPS)
    del p1
    step, _, _ = train.make_hfl_train_step(
        cfg, hm, g1=2, g2=2, **dict(cs.TRAIN_KW, attn_chunk=128))
    t0 = time.perf_counter()
    params = step(params, token_batch(0, 8, 128, cfg.vocab, device=dev))
    torch.cuda.synchronize()
    with torch.no_grad():
        loss = float(model.loss(train._map(lambda a: a[0, 0, 0], params),
                                token_batch(9999, 8, 128, cfg.vocab,
                                            device=dev)))
    full = {"loss": loss, "reorder_rel": (0.0,),
            "stats": [cs._leaf_stats(torch, a[0, 0, 0])
                      for a in train._leaves(params)]}
    print(f"3g (b): round {time.perf_counter() - t0:.3f} s, loss {loss:.6f}")
    del params, step
    torch.cuda.empty_cache()
    cs._tp_rank = plain_rank
    for plain in ("0", "1"):
        os.environ["TP_PLAIN"] = plain
        print(f"phase 3l, {'plain' if plain == '1' else 'port'} products:",
              flush=True)
        try:
            cs.tensor_plane(torch, {"full": full}, "3l")
        except RuntimeError as e:        # chip_smoke.check's failure
            print(f"  {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
