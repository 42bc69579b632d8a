"""Serving on one device: prefill, then greedy one-token decode; the
single-device port of ``repro.launch.serve`` and of
``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --window 32 --prompt-len 48
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --device cpu

The step factories return the step callables; there is no mesh, so the
reference's parameter and cache shardings (``serve_specs_for_params``,
``cache_specs``) have no counterpart yet (ROADMAP.md, "Modules still to
port", item 10 (b)). ``main`` runs a model at full width by default,
with random weights drawn from ``--seed``; ``--reduced`` serves
``cfg.reduce()``; ``--window N`` serves from a ring-buffer cache of the
last N positions (sliding-window attention, the reference's
``long_500k`` path). The stub front ends' inputs are drawn as
``examples/serve_decode.py`` draws them: normal f32 from numpy's
``default_rng(--seed)``, whisper's frame embeddings (B, enc_seq, d) and
qwen2-vl's patch embeddings (B, vision_tokens, d). Attention runs
through the ``flash_attention`` kernel and RWKV6's multi-token WKV
through ``wkv6`` on the card; an MoE model's experts are batched
matmuls.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.model import build_model


def make_prefill_step(cfg, *, window: int = 0, max_new: int = 0):
    """Returns ``prefill_step(params, batch) -> (last logits (B, V),
    cache)``; ``batch`` is {"tokens": (B, S) int} plus the stub front
    ends' ``enc_embed`` / ``vision_embed``, and the cache keeps
    ``max_new`` free slots for the decode steps (none with a ``window``:
    the ring wraps)."""
    model = build_model(cfg)

    def prefill_step(params, batch_):
        extras = {k: batch_[k] for k in transformer.EXTRAS if k in batch_}
        return model.prefill(params, batch_["tokens"], extras=extras,
                             window=window, max_new=max_new)

    return prefill_step


def make_decode_step(cfg, *, window: int = 0):
    """Returns ``serve_step(params, cache, tokens (B, 1)) -> (logits
    (B, V), cache)``; the cache is updated in place."""
    model = build_model(cfg)

    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, window=window)

    return serve_step


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def greedy_serve(cfg, params, tokens, new_tokens: int, *,
                 window: int = 0, extras=None) -> dict:
    """Prefill ``tokens`` (B, S), then ``new_tokens`` greedy decode steps,
    each fed the argmax of the previous logits; with ``window`` > 0 from a
    ring-buffer cache under a sliding window of that many positions.
    ``extras``: the stub front ends' inputs (``enc_embed``,
    ``vision_embed``) for the prefill. Returns

        logits    -- [prefill logits, then each decode step's] (B, V) each
        tokens    -- (B, new_tokens) the greedy tokens fed to the decode
        cache     -- the cache after the last step
        prefill_s -- wall seconds of the prefill (device synchronised)
        decode_s  -- wall seconds of the decode loop
        tok_per_s -- new_tokens * B / decode_s
    """
    dev = tokens.device
    prefill_step = make_prefill_step(cfg, window=window, max_new=new_tokens)
    decode_step = make_decode_step(cfg, window=window)
    t0 = _sync(dev)
    logits, cache = prefill_step(params, {"tokens": tokens,
                                          **(extras or {})})
    t1 = _sync(dev)
    outs = [logits]
    fed = []
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    for _ in range(new_tokens):
        fed.append(nxt)
        logits, cache = decode_step(params, cache, nxt)
        outs.append(logits)
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
    t2 = _sync(dev)
    b = tokens.shape[0]
    gen = (torch.cat(fed, dim=1) if fed
           else torch.zeros((b, 0), dtype=torch.int32, device=dev))
    return {"logits": outs, "tokens": gen, "cache": cache,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "tok_per_s": new_tokens * b / max(t2 - t1, 1e-12)}


def stub_extras(cfg, batch: int, seed: int, device) -> dict:
    """The stub front ends' inputs, as ``examples/serve_decode.py`` draws
    them: normal f32 from ``np.random.default_rng(seed)``, whisper's frame
    embeddings ``enc_embed`` (B, enc_seq, d) or qwen2-vl's patch
    embeddings ``vision_embed`` (B, vision_tokens, d); {} for the other
    families."""
    shape = {"audio": ("enc_embed", cfg.enc_seq),
             "vlm": ("vision_embed", cfg.vision_tokens)}.get(cfg.family)
    if shape is None:
        return {}
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, shape[1], cfg.d_model)).astype(np.float32)
    return {shape[0]: torch.from_numpy(a).to(resolve_device(device))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="serve cfg.reduce() (2 layers, d_model 256)")
    ap.add_argument("--window", type=int, default=0,
                    help="serve from a ring buffer of this many positions "
                    "(sliding-window attention); 0: the whole sequence")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    cfg = cfg.reduce() if args.reduced else cfg
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        dev)
    toks = token_batch(0, args.batch, args.prompt_len, cfg.vocab,
                       dev)["tokens"]
    res = greedy_serve(cfg, params, toks, args.new_tokens,
                       window=args.window,
                       extras=stub_extras(cfg, args.batch, args.seed, dev))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''} on {name}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}"
          + (f", window {args.window}" if args.window else ""))
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{res['prefill_s']:.3f}s")
    print(f"decoded {args.new_tokens} tokens x{args.batch} in "
          f"{res['decode_s']:.3f}s ({res['tok_per_s']:.1f} tok/s)")
    print("greedy continuation (first sequence):",
          res["tokens"][0].tolist())
    return res


if __name__ == "__main__":
    main()
