"""How far one hierarchical train round of the reduced LLM configs moves
when its start moves by one f32 rounding, in each package, beside the gap
between the packages: the evidence behind ``tests/_torch_train_ref.py``'s
settings for rwkv6 (one minibatch per epoch, no bf16 step case).

For each arch, activation dtype, minibatches per epoch and seed it runs
the (2, 2) round of ``tests/_torch_train_ref.py`` (replicas (1, 2, 2),
batch 8 x seq 32, lr 3e-3, KV chunks of 16) from the reference's
``model.init(PRNGKey(seed))`` on ``token_batch(seed, ...)``:

- ``ref~ref``: the reference's jitted step from the start and from the
  start with every leaf scaled by ``1 + 1e-7 z`` (z standard normal,
  numpy seed 1);
- ``port~port``: the same perturbation through the port's step;
- ``port~ref``: the port's step against the reference's, same start.

Each is the largest absolute difference over replica (0, 0, 0)'s leaves
after the round. Runs on the CPU with 4 forced host devices:

    PYTHONPATH=src python tests/_torch_rwkv6_conditioning.py
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import _torch_train_ref as tref  # noqa: E402

SEEDS = (0, 1, 2)
PERTURB = 1e-7
# (arch, activation dtype, minibatches per epoch): rwkv6 at both dtypes
# and both settings, qwen3 at the test's settings as the control
RUNS = [("rwkv6-1.6b", "float32", 1), ("rwkv6-1.6b", "float32", 2),
        ("rwkv6-1.6b", "bfloat16", 1), ("rwkv6-1.6b", "bfloat16", 2),
        ("qwen3-1.7b", "float32", 2), ("qwen3-1.7b", "bfloat16", 2)]


def _perturbed(flat: dict) -> dict:
    rng = np.random.default_rng(1)
    return {k: (v * (1 + PERTURB * rng.standard_normal(v.shape))
                ).astype(np.float32) for k, v in flat.items()}


def _nest(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def _gap(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def main() -> None:
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh

    from repro import configs as jconfigs
    from repro.data.synthetic import token_batch as jtoken_batch
    from repro.launch import mesh as jmesh
    from repro.launch import train as jtrain
    from repro.models import build_model as jbuild
    from repro_torch import configs, weights
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import mesh, train

    jm = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2, 1, 1),
              jmesh.HFL_AXES)
    hm = mesh.make_hfl_mesh((1, 2, 2), device="cpu")
    print(f"{'arch':11s} {'act':9s} mb steps seed  ref~ref    "
          f"port~port  port~ref")
    for arch, act, mb in RUNS:
        jcfg = tref.config(arch, act, jconfigs)
        cfg = tref.config(arch, act, configs)
        kw = dict(tref.STEP, mb_per_epoch=mb, **tref.STATIC)
        jstep = jax.jit(jtrain.make_hfl_train_step(jcfg, jm, **kw)[0])
        step = train.make_hfl_train_step(cfg, hm, **kw)[0]

        def ref(flat, seed):
            p = jtrain.lift_params(jax.tree.map(jnp.asarray, _nest(flat)),
                                   1, 2, 2)
            out = jstep(p, jtoken_batch(seed, tref.BATCH, tref.SEQ,
                                        jcfg.vocab))
            return {k: np.asarray(v, np.float32)[0, 0, 0]
                    for k, v in tref._flat(out).items()}

        def port(flat, seed):
            p = train.lift_params(weights.tree_from_numpy(_nest(flat),
                                                          "cpu"), 1, 2, 2)
            out = step(p, token_batch(seed, tref.BATCH, tref.SEQ, cfg.vocab,
                                      device="cpu"))
            return {k: v.to(torch.float32).numpy()[0, 0, 0]
                    for k, v in tref._flat(out).items()}

        for seed in SEEDS:
            p0 = {k: np.asarray(v, np.float32) for k, v in tref._flat(
                jbuild(jcfg).init(jax.random.PRNGKey(seed))).items()}
            r0, t0 = ref(p0, seed), port(p0, seed)
            pp = _perturbed(p0)
            r1, t1 = ref(pp, seed), port(pp, seed)
            steps = 2 * 2 * mb                    # g1 g2 epochs of mb
            print(f"{arch:11s} {act:9s} {mb:2d} {steps:5d} {seed:4d}  "
                  f"{_gap(r0, r1):.3e}  {_gap(t0, t1):.3e}  "
                  f"{_gap(t0, r0):.3e}", flush=True)


if __name__ == "__main__":
    main()
