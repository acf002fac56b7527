#!/usr/bin/env python3
"""How far an SSM model's chunked and recurrent f32 paths can agree.

For xlstm-1.3b (or zamba2-7b) at a given width, depth and prompt length,
in f32 on the CPU, in both the JAX package and the PyTorch port, with the
same weights (the reference's, carried across by ``params_from_jax``):

* the chunked full-sequence logits (``forward``) against ``decode_step``
  run token by token from ``init_cache``'s zero states: max and mean
  abs difference;
* the model's own f32 sensitivity: how far the chunked logits move when
  the embedding table is multiplied by ``1 + 2^-24 * N(0, 1)`` (one unit
  roundoff).

``chip_smoke.py`` gates the card's chunked-against-recurrent logits by
that floor where it exceeds 1e-3.  Run from the repo root:

    PYTHONPATH=src python tools/ssm_sensitivity.py --d-model 512 \\
        --layers 16 --prompt 300
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def deviations(full: np.ndarray, steps: list, perturbed: np.ndarray) -> dict:
    rec = np.stack(steps, axis=1)
    d, f = np.abs(rec - full), np.abs(perturbed - full)
    return {"recurrent_max": float(d.max()), "recurrent_mean": float(d.mean()),
            "floor_max": float(f.max()), "floor_mean": float(f.mean()),
            "std": float(full.std())}


def run_jax(cfg, params, batch, noise) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jt

    full = np.asarray(jt.forward(cfg, params, batch))
    step = jax.jit(lambda c, t: jt.decode_step(cfg, params, c, t))
    cache = jt.init_cache(cfg, batch["tokens"].shape[0],
                          batch["tokens"].shape[1])
    steps = []
    for t in range(batch["tokens"].shape[1]):
        logits, cache = step(cache, batch["tokens"][:, t:t + 1])
        steps.append(np.asarray(logits)[:, 0])
    moved = dict(params, embed=params["embed"] * (1 + jnp.asarray(noise)))
    return deviations(full, steps, np.asarray(jt.forward(cfg, moved, batch)))


def run_port(cfg, tree, batch, noise) -> dict:
    import torch

    from repro_torch.models import (
        decode_step, forward, init_cache, params_from_jax,
    )

    model = params_from_jax(cfg, tree, device="cpu")
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]))}
    full = forward(cfg, model, tb).numpy()
    cache = init_cache(cfg, tb["tokens"].shape[0], tb["tokens"].shape[1],
                       device="cpu")
    steps = []
    for t in range(tb["tokens"].shape[1]):
        logits, cache = decode_step(cfg, model, cache,
                                    tb["tokens"][:, t:t + 1])
        steps.append(logits[:, 0].numpy())
    with torch.no_grad():
        model.embed.mul_(1 + torch.from_numpy(noise))
    return deviations(full, steps, forward(cfg, model, tb).numpy())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-1.3b",
                    choices=("xlstm-1.3b", "zamba2-7b"))
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from repro import configs as jax_configs
    from repro.models import io as jax_io
    from repro.models import transformer as jt
    from repro_torch import configs

    cut = dict(d_model=args.d_model, n_layers=args.layers, dtype="float32",
               vocab_size=args.vocab)
    jcfg = dataclasses.replace(jax_configs.get_config(args.arch), **cut)
    tcfg = dataclasses.replace(configs.get_config(args.arch), **cut)
    params = jt.init_params(jcfg, jax.random.key(args.seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    batch = jax_io.make_batch(jcfg, args.batch, args.prompt, seed=args.seed)
    noise = (2.0 ** -24 * np.random.default_rng(args.seed + 1)
             .standard_normal(tree["embed"].shape)).astype(np.float32)
    out = {"jax": run_jax(jcfg, params, batch, noise),
           "port": run_port(tcfg, tree, batch, noise)}
    print(f"{args.arch}, d_model {args.d_model}, {args.layers} layers, "
          f"{args.batch} x {args.prompt} tokens, f32 on the CPU:")
    for name, dev in out.items():
        print(f"  {name}: chunked against recurrent max "
              f"{dev['recurrent_max']:.3e}, mean {dev['recurrent_mean']:.3e};"
              f" embeddings moved by 2^-24: max {dev['floor_max']:.3e}, mean "
              f"{dev['floor_mean']:.3e} (logits' std {dev['std']:.4f})")
    return out


if __name__ == "__main__":
    main()
