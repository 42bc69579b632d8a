"""Serving: prefill, then greedy one-token decode, on one device or
over the ranks of a ``("pod", "batch", "tp")`` serve mesh; the port of
``repro.launch.serve`` and of ``examples/serve_decode.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --window 32 --prompt-len 48
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --reduced --device cpu --tp 2

**The serve layout.** Serving has no replicas: the request batch is split
over ``("pod", "batch")`` where it divides (``_batch_axes``), each
model's tensors over ``tp`` as the reference's serve specs lay them
(``serve_specs_for_params``: the train layout's ``("fsdp", "tp")``
entries remapped to ``tp``, a dimension ``tp`` does not divide kept
whole, and for models over 4 GiB a device the reference's ``fsdp_serve``
merge over ``("batch", "tp")``), the decode cache's kv heads over ``tp``
(``cache_specs``). These are pure functions of ``mesh.shape`` and return
specs as tuples (``launch.mesh``). With a ``launch.mesh.ServeMesh`` the
step factories return the reference's tuple, each "sharding" the rank's
index from ``mesh.shardings``; the layers then run the rank's heads,
FFN columns and vocabulary block (``models.decode``, ``tp=``), and each
rank's outputs are its shard under the reference's output shardings:
the prefill logits over (the batch axes, ``tp`` where it divides the
vocabulary), the decode logits whole on every rank (``P()`` in the
reference's dry run), the cache blocks as ``cache_specs`` gives them.
Only the dense family is served over a mesh, at a T that divides both
head counts, without ``fsdp_serve`` (``models.tp.check_serve``, and
``NotImplementedError`` for ``fsdp_serve``): mesh serving of the other
families, the cache split over its length where T does not divide the kv
heads, and ``fsdp_serve`` are ROADMAP.md, "Modules still to port", item
10 (b).

``main`` runs a model at full width by default, with random weights
drawn from ``--seed``; ``--reduced`` serves ``cfg.reduce()``; ``--window
N`` serves from a ring-buffer cache of the last N positions
(sliding-window attention, the reference's ``long_500k`` path); ``--tp
T`` under ``torchrun`` serves over the serve mesh of the world, T tp
ranks a batch group (gloo: CPU and CUDA tensors). The stub front ends'
inputs are drawn as ``examples/serve_decode.py`` draws them: normal f32
from numpy's ``default_rng(--seed)``, whisper's frame embeddings (B,
enc_seq, d) and qwen2-vl's patch embeddings (B, vision_tokens, d).
Attention runs through the ``flash_attention`` kernel and RWKV6's
multi-token WKV through ``wkv6`` on the card; an MoE model's experts are
batched matmuls.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_batch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ssm, transformer
from repro_torch.models import tp as tp_mod
from repro_torch.models.model import build_model

# a model above this many bytes of parameters a tp rank is served with its
# big weights merged over ("batch", "tp") (the reference's fsdp_serve)
FSDP_SERVE_BYTES = 4 * 2 ** 30


def _batch_axes(mesh, b: int):
    """Shard the request batch over ('pod', 'batch') when divisible,
    else over 'batch' alone, else replicate (bs=1 long-context)."""
    npod = mesh.shape["pod"]
    nb = mesh.shape["batch"]
    if b % (npod * nb) == 0:
        return ("pod", "batch")
    if b % nb == 0:
        return ("batch",)
    return None


def _entry(axes):
    """A spec entry as a ``PartitionSpec`` keeps it: a one-axis tuple is
    the axis name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _fsdp_serve(mesh, pshape) -> bool:
    """The reference's ``fsdp_serve``: parameters over
    ``FSDP_SERVE_BYTES`` a tp rank."""
    nbytes = sum(a.numel() * a.element_size()
                 for a in _leaves(pshape)) / mesh.shape["tp"]
    return nbytes > FSDP_SERVE_BYTES


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


def serve_specs_for_params(cfg, mesh) -> dict:
    """Serve-layout param specs: 'fsdp' references remap to 'tp' (the
    serve mesh has no fsdp axis), and any sharded dim the axis size does
    not divide falls back to replication (e.g. whisper's odd 51865
    vocab), as the reference's jax rejects non-divisible shardings.

    Big models (``_fsdp_serve``) additionally shard the merged
    ('fsdp', 'tp') weight axes over ('batch', 'tp'), with the
    reference's dim-swap fallback onto the other tail dim where the
    intended one is not divisible (qwen2-72b's d_ff = 29568). The shapes
    come from the port's own init on the meta device; ``mesh`` is read
    only through ``mesh.shape``."""
    pshape = transformer.meta_params(cfg)
    specs = mesh_lib.serve_param_specs(cfg, pshape)
    tp = mesh.shape["tp"]
    nb = mesh.shape["batch"]
    fsdp_serve = _fsdp_serve(mesh, pshape)
    merged = ("batch", "tp") if fsdp_serve else "tp"
    msize = nb * tp if fsdp_serve else tp

    def remap(spec, shape):
        ndim = len(shape)
        out = []
        merged_dim = None
        for i, s_ in enumerate(spec):
            if isinstance(s_, tuple) and "fsdp" in s_:
                if shape[i] % msize == 0:
                    s_ = merged
                    merged_dim = i
                else:
                    s_ = "tp"
            if s_ == "tp" and shape[i] % tp != 0:
                s_ = None
            out.append(s_)
        if fsdp_serve and merged_dim is None and ndim >= 2:
            # dim-swap fallback: shard the other tail dim when the
            # intended one is not msize-divisible
            for i in (ndim - 2, ndim - 1):
                if out[i] in ("tp", None) and shape[i] % msize == 0 \
                        and shape[i] >= 4096:
                    out[i] = merged
                    # drop a conflicting tp on the swapped-away dim
                    other = ndim - 1 if i == ndim - 2 else ndim - 2
                    if out[other] == "tp":
                        out[other] = None
                    break
        return tuple(out)

    return mesh_lib._map_specs(remap, specs, pshape)


def cache_specs(cfg, mesh, batch: int) -> dict:
    """Specs of the decode cache: the batch over ``_batch_axes``; kv
    caches shard the kv-head dim over 'tp' when divisible, otherwise the
    cache length dim (flash-decode style sequence sharding), for every
    family, as the reference lays them. The host ints ``t`` and
    ``dpos`` are ``()``."""
    ba = _entry(_batch_axes(mesh, batch))
    tp = mesh.shape["tp"]
    fam = cfg.family
    heads_ok = cfg.n_kv_heads % tp == 0

    def mk(*rest):
        return (None, ba) + rest

    def kv():
        return mk(None, "tp", None) if heads_ok else mk("tp", None, None)

    if fam in ("dense", "moe", "vlm"):
        out = {"k": kv(), "v": kv(),
               "pos": mk("tp" if not heads_ok else None), "t": ()}
        if cfg.m_rope:
            out["dpos"] = ()
        return out
    if fam == "ssm":
        nh_ok = cfg.n_heads % tp == 0
        return {"ax": mk(None), "S": mk("tp" if nh_ok else None, None, None),
                "cx": mk(None), "t": ()}
    if fam == "hybrid":
        _, nh, _, _ = ssm.mamba2_dims(cfg)
        nh_ok = nh % tp == 0
        return {"h": mk("tp" if nh_ok else None, None, None),
                "tail": mk(None, None),
                "ak": kv(), "av": kv(),
                "apos": mk("tp" if not heads_ok else None), "t": ()}
    if fam == "audio":
        hx = "tp" if heads_ok else None
        return {"k": kv(), "v": kv(),
                "pos": mk("tp" if not heads_ok else None),
                "ck": mk(None, hx, None), "cv": mk(None, hx, None),
                "t": ()}
    raise ValueError(fam)


def _param_sh(cfg, mesh) -> dict:
    """This rank's index into every parameter under the serve specs;
    raises where the port cannot serve ``cfg`` over ``mesh``
    (``tp.check_serve``; ``fsdp_serve``, whose merged and swapped
    weights the layers do not run: ``NotImplementedError``)."""
    tp_mod.check_serve(cfg, mesh.shape["tp"])
    pshape = transformer.meta_params(cfg)
    if _fsdp_serve(mesh, pshape):
        raise NotImplementedError(
            f"{cfg.name}: over {FSDP_SERVE_BYTES / 2 ** 30:.0f} GiB of "
            f"parameters a tp rank, served with weights merged over "
            f"('batch', 'tp') (the reference's fsdp_serve): "
            f"{tp_mod.TP_ITEM}")
    return mesh_lib.shardings(mesh, serve_specs_for_params(cfg, mesh),
                              pshape)


def _logits_spec(cfg, mesh, batch: int) -> tuple:
    """The reference's prefill logits sharding: the batch axes, and
    'tp' where it divides the vocabulary."""
    return (_entry(_batch_axes(mesh, batch)),
            "tp" if cfg.vocab % mesh.shape["tp"] == 0 else None)


def _cache_shapes(cfg, batch: int, cache_len: int) -> dict:
    """The whole decode cache's shapes (the dense family's)."""
    kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv, "pos": kv[:3], "t": ()}


def take(tree, index):
    """Each leaf of ``tree`` at its index of ``index`` (a tree of index
    tuples, ``mesh.shardings``), a new contiguous tensor: a rank's
    blocks of the whole parameters or cache."""
    if isinstance(tree, dict):
        return {k: take(v, index[k]) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return tree[index].clone(memory_format=torch.contiguous_format)


def make_prefill_step(cfg, mesh=None, *, batch=None, seq=None,
                      window: int = 0, max_new: int = 0):
    """Without ``mesh``: ``prefill_step(params, batch) -> (last logits
    (B, V), cache)``; ``batch`` is {"tokens": (B, S) int} plus the stub
    front ends' ``enc_embed`` / ``vision_embed``, and the cache keeps
    ``max_new`` free slots for the decode steps (none with a ``window``:
    the ring wraps).

    With a ``launch.mesh.ServeMesh`` (``batch``, ``seq`` the whole
    request's; the dense family only): ``(prefill_step, param_sh,
    batch_sh, (logits_sh, cache_sh))``, each "sharding" this rank's
    index into the whole tensor (``mesh.shardings``; ``take``): its
    blocks of the parameters, its rows of the batch, and where its
    outputs lie in the whole logits (B, V) and cache. ``prefill_step``
    takes the rank's blocks and rows and returns exactly its shards of
    the reference's outputs."""
    model = build_model(cfg)
    if mesh is None:
        def prefill_step(params, batch_):
            extras = {k: batch_[k] for k in transformer.EXTRAS
                      if k in batch_}
            return model.prefill(params, batch_["tokens"], extras=extras,
                                 window=window, max_new=max_new)

        return prefill_step
    param_sh = _param_sh(cfg, mesh)
    tp = mesh.tp_context

    def prefill_step(params, batch_):
        return model.prefill(params, batch_["tokens"], window=window,
                             max_new=max_new, tp=tp)

    ba = _entry(_batch_axes(mesh, batch))
    batch_sh = mesh.index((ba,), (batch,))
    logits_sh = mesh.index(_logits_spec(cfg, mesh, batch),
                           (batch, cfg.vocab))
    cache_len = min(seq, window) if window else seq + max_new
    cache_sh = mesh_lib.shardings(mesh, cache_specs(cfg, mesh, batch),
                                  _cache_shapes(cfg, batch, cache_len))
    return prefill_step, param_sh, batch_sh, (logits_sh, cache_sh)


def make_decode_step(cfg, mesh=None, *, batch=None, cache_len=None,
                     window: int = 0):
    """Without ``mesh``: ``serve_step(params, cache, tokens (B, 1)) ->
    (logits (B, V), cache)``; the cache is updated in place.

    With a ``launch.mesh.ServeMesh`` (``batch``, ``cache_len`` the whole
    cache's; the dense family only): ``(serve_step, param_sh, cache_sh,
    token_sh)`` as in ``make_prefill_step``; ``serve_step`` takes the
    rank's blocks, cache block and token rows and returns the whole
    logits (B, V) on every rank (the reference's replicated output,
    joined by ``mesh.gather_serve``: one ``all_gather``) and its cache
    block, updated in place."""
    model = build_model(cfg)
    if mesh is None:
        def serve_step(params, cache, tokens):
            return model.decode_step(params, cache, tokens, window=window)

        return serve_step
    param_sh = _param_sh(cfg, mesh)
    tp = mesh.tp_context
    spec = _logits_spec(cfg, mesh, batch)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens,
                                          window=window, tp=tp)
        return mesh_lib.gather_serve(logits, spec, mesh), cache

    cache_sh = mesh_lib.shardings(mesh, cache_specs(cfg, mesh, batch),
                                  _cache_shapes(cfg, batch, cache_len))
    token_sh = mesh.index((_entry(_batch_axes(mesh, batch)), None),
                          (batch, 1))
    return serve_step, param_sh, cache_sh, token_sh


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def greedy_serve(cfg, params, tokens, new_tokens: int, *,
                 window: int = 0, extras=None, mesh=None,
                 forced=None) -> dict:
    """Prefill ``tokens`` (B, S), then ``new_tokens`` greedy decode steps,
    each fed the argmax of the previous logits; with ``window`` > 0 from a
    ring-buffer cache under a sliding window of that many positions.
    ``extras``: the stub front ends' inputs (``enc_embed``,
    ``vision_embed``) for the prefill. ``forced`` (B, new_tokens): the
    tokens to feed instead of the argmax (teacher forcing). ``mesh`` (a
    ``launch.mesh.ServeMesh``, which every rank of it calls this with):
    ``params`` are this rank's blocks (``take`` of the step factories'
    ``param_sh``), ``tokens`` the whole prompt, and each step's logits
    are joined whole on every rank (``mesh.gather_serve``). Returns

        logits    -- [prefill logits, then each decode step's] (B, V) each
        tokens    -- (B, new_tokens) the tokens fed to the decode
        cache     -- the cache after the last step (a rank's block)
        prefill_s -- wall seconds of the prefill (device synchronised)
        decode_s  -- wall seconds of the decode loop
        tok_per_s -- new_tokens * B / decode_s
    """
    dev = tokens.device
    b, s = tokens.shape
    rows = slice(None)
    if mesh is None:
        prefill_step = make_prefill_step(cfg, window=window,
                                         max_new=new_tokens)
        decode_step = make_decode_step(cfg, window=window)
        join = lambda lg: lg
    else:
        prefill_step, _, (rows,), _ = make_prefill_step(
            cfg, mesh, batch=b, seq=s, window=window, max_new=new_tokens)
        decode_step, *_ = make_decode_step(
            cfg, mesh, batch=b, window=window,
            cache_len=min(s, window) if window else s + new_tokens)
        spec = _logits_spec(cfg, mesh, b)
        join = lambda lg: mesh_lib.gather_serve(lg, spec, mesh)
    t0 = _sync(dev)
    logits, cache = prefill_step(params, {"tokens": tokens[rows],
                                          **(extras or {})})
    logits = join(logits)
    t1 = _sync(dev)
    outs = [logits]
    fed = []
    nxt = logits.argmax(-1)[:, None].to(torch.int32)
    for i in range(new_tokens):
        if forced is not None:
            nxt = forced[:, i:i + 1].to(torch.int32)
        fed.append(nxt)
        logits, cache = decode_step(params, cache, nxt[rows])
        outs.append(logits)
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
    t2 = _sync(dev)
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
    ap.add_argument("--tp", type=int, default=0,
                    help="under torchrun: serve over the world's serve mesh, "
                    "this many tp ranks a batch group (the dense family); "
                    "0: one device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cfg = cfg.reduce() if args.reduced else cfg
    model = build_model(cfg)
    owned = mesh_lib.torchrun_world() if args.tp else False
    try:
        mesh = (mesh_lib.make_serve_mesh(args.tp, device=args.device)
                if args.tp else None)
        dev = resolve_device(args.device) if mesh is None else mesh.device
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        if mesh is not None:
            _, param_sh, _, _ = make_prefill_step(
                cfg, mesh, batch=args.batch, seq=args.prompt_len,
                window=args.window, max_new=args.new_tokens)
            params = take(params, param_sh)
        toks = token_batch(0, args.batch, args.prompt_len, cfg.vocab,
                           dev)["tokens"]
        res = greedy_serve(cfg, params, toks, args.new_tokens,
                           window=args.window, mesh=mesh,
                           extras=stub_extras(cfg, args.batch, args.seed, dev))
        if mesh is None or mesh.rank == 0:
            _report(cfg, args, dev, res, mesh)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()
    return res


def _report(cfg, args, dev, res, mesh) -> None:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{cfg.name}{' (reduced)' if args.reduced else ''} on {name}: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}"
          + (f", window {args.window}" if args.window else "")
          + (f", serve mesh {mesh.shape}" if mesh is not None else ""))
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{res['prefill_s']:.3f}s")
    print(f"decoded {args.new_tokens} tokens x{args.batch} in "
          f"{res['decode_s']:.3f}s ({res['tok_per_s']:.1f} tok/s)")
    print("greedy continuation (first sequence):",
          res["tokens"][0].tolist())


if __name__ == "__main__":
    main()
