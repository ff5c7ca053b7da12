"""Batched serving driver (decode loop with KV cache), the port of
``repro.launch.serve``.

Serves a REDUCED-config model: prefill a batch of random prompts one token
at a time, then decode greedily with the per-family cache (KV / RG-LRU
state).  Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is
given; on the card every windowed, uncapped attention layer runs the
``swa_decode`` kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch import device as _device
from repro_torch.models import api


def prefill_into_cache(cfg, params, cache, prompts: torch.Tensor):
    """Feed the prompt tokens (b, p) one step at a time (teacher-forced
    prefill): returns (cache, logits (b, 1, vocab) of the last step).

    Production prefill is a fused full-sequence step; the token-stepped
    variant keeps the serving loop family-agnostic, as in the reference."""
    step = api.make_serve_step(cfg)
    logits = torch.zeros((prompts.shape[0], 1, cfg.vocab_size), dtype=torch.float32,
                         device=prompts.device)
    for t in range(prompts.shape[1]):
        cache, logits = step(params, cache, prompts[:, t:t + 1])
    return cache, logits


def decode_tokens(cfg, params, cache, last_logits: torch.Tensor, n_new: int):
    """Greedy decode loop, one token per step: returns (cache after the
    last step, the (batch, n_new) int32 tokens), each token the argmax of
    the previous step's logits (first maximum on ties, as ``jnp.argmax``).
    The reference returns the tokens alone."""
    step = api.make_serve_step(cfg)
    logits, toks = last_logits, []
    for _ in range(n_new):
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        cache, logits = step(params, cache, tok[:, None])
        toks.append(tok)
    return cache, torch.stack(toks, dim=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None, device: torch.device | str | None = None) -> dict:
    """Run the serving driver; ``argv`` defaults to ``sys.argv[1:]``.
    ``device=None`` (and no ``--device``) means the card.  Prints and
    returns the summary."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = _device.resolve(device if device is not None else args.device)

    cfg = configs.get(args.arch, reduced=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(g, cfg)
    max_seq = args.prompt_len + args.new_tokens + 1
    cache = api.init_cache(cfg, args.batch, max_seq, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g,
                            device=dev, dtype=torch.int32)

    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill_into_cache(cfg, params, cache, prompts)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, toks = decode_tokens(cfg, params, cache, logits, args.new_tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = {
        "arch": args.arch,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "new_tokens": args.new_tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": args.batch * args.new_tokens / max(t_decode, 1e-9),
        "sample_output": toks[0, :8].tolist(),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
