"""Serving driver: batched generation on random weights.

The port of ``src/repro/launch/serve.py``.  On the card, at full width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \
      --batch 4 --prompt-len 2048 --new-tokens 32

On the CPU, at the reduced size the tests use:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

``--arch`` takes every architecture whose model takes tokens only: the
dense and moe ones, xlstm-1.3b (ssm) and zamba2-7b (hybrid), for example

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --batch 4 --prompt-len 2048 --new-tokens 32

Unlike the reference, whose ``--reduced`` cannot be turned off, the full
configuration is the default and ``--reduced`` opts in.  Weights are drawn
from ``--seed`` on the device, layer by layer; prompts from numpy's
``default_rng(seed)``, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config, reduced
from ..device import resolve_device
from ..models import init_params
from ..serving import ServeConfig, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of the CPU tests")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=3,
                    help="number of serving rounds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attention", choices=("pallas", "reference"),
                    default="pallas",
                    help="prefill attention: 'pallas' runs the Hopper "
                         "flash-attention kernel, 'reference' the plain path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the prompts")
    return ap


def main(argv=None) -> ServingEngine:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, attention_impl=args.attention)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device=device)
    engine = ServingEngine(cfg, model, ServeConfig(
        max_len=args.prompt_len + args.new_tokens,
        temperature=args.temperature, seed=args.seed), device=device)

    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        prompts = rng.integers(
            0, cfg.vocab_size,
            (args.batch, args.prompt_len)).astype(np.int32)
        out = engine.generate(prompts, args.new_tokens)
        print(f"[serve] round {r}: generated {out.shape} "
              f"({engine.tokens_per_s:.1f} tok/s cumulative)")
    print(f"[serve] {cfg.name} on {device} ({cfg.dtype}, attention "
          f"{cfg.attention_impl}): prefill {engine.stats['prefill_s']:.2f}s, "
          f"decode {engine.stats['decode_s']:.2f}s, "
          f"{engine.stats['tokens']} tokens")
    return engine


if __name__ == "__main__":
    main()
