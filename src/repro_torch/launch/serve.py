"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id>``.

Counterpart of ``repro.launch.serve``: batched request serving through the
Engine (prefill + decode with caches), optionally guarded by the Bloom
n-gram repetition filter, on ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions). ``--no-smoke`` builds the architecture at its full
width (random f32 parameters from seed 0).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mistral-nemo-12b --no-smoke --guard --batch 8 \
        --requests 16 --prompt-len 64 --new-tokens 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.ngram_guard import NGramGuard


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--smoke", dest="smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--guard", action="store_true",
                    help="enable the Bloom n-gram repetition guard")
    ap.add_argument("--guard-decay-every", type=int, default=None,
                    help="time-decayed guard: counting filter + one decay "
                         "per N observed steps (long-running serve loops)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, params=None):
    """(model, params, engine, requests) for the parsed flags. ``params``,
    where given, are the model's parameters on the device, reused (a
    full-width model's f32 parameters fill most of a card)."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.is_encdec:
        raise SystemExit("enc-dec serving needs --src features; use the "
                         "examples for seamless")
    device = resolve_device(args.device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
    guard = (NGramGuard(batch=args.batch, n=3, top_k=64,
                        decay_every=args.guard_decay_every, device=device)
             if args.guard or args.guard_decay_every else None)
    engine = Engine(model, params, batch=args.batch, max_len=args.max_len,
                    guard=guard)
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(2, cfg.vocab,
                                       args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    return model, params, engine, reqs


def run(args: argparse.Namespace, model, engine: Engine, reqs) -> list:
    """Serve ``reqs`` through ``engine`` and print what was served; returns
    the generated tokens of each request."""
    guard = engine.guard
    print(f"[serve] {args.arch} ({model.param_count()/1e6:.1f}M params)")
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s)")
    if guard:
        st = guard.stats
        print(f"[serve] guard: {st.observed} n-grams recorded, "
              f"{st.penalized} candidates penalized, {st.decays} decays "
              f"(engine {guard.filt.backend!r})")
        health = {k: v for k, v in engine.stats().items()
                  if k not in ("guard.observed", "guard.penalized",
                               "guard.decays")}
        print("[serve] guard health: " + ", ".join(
            f"{k.removeprefix('guard.')}={v:.4g}"
            for k, v in health.items()))
    print(f"[serve] sample: {outs[0][:12]}")
    return outs


def main(argv=None):
    args = parse_args(argv)
    model, _, engine, reqs = build(args)
    run(args, model, engine, reqs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
