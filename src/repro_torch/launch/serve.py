"""Serving launcher: greedy generation for every registered architecture.

Port of ``repro/launch/serve.py``. ``greedy_generate`` feeds the prompt
through ``decode_step`` one token at a time (the cache-consistent path),
then decodes greedily. As in the reference, decoding takes no frontend
input: seamless-m4t decodes against its cache's all-zero cross-attention
memory, internvl2 without image patches. Same arguments and log line as
the reference, plus ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs on the CPU). The ``--arch`` configs keep the kernel flags off, as in the
reference: decoding reaches no kernel; ``prefill`` with the flags on does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --reduced --device cpu --batch 4 --context 32 --gen 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import model as MDL
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import log


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def greedy_generate(cfg, params, prompt_tokens, gen_len: int, window: int = 0):
    """Prefill via repeated decode_step over the prompt (teacher-forced),
    then greedy generation. Returns (generated (B, gen_len), steps/s)."""
    b, prompt_len = prompt_tokens.shape
    device = prompt_tokens.device
    cache = MDL.init_cache(cfg, b, prompt_len + gen_len, window, device=device)
    step = make_decode_step(cfg, window)

    logits = None
    for i in range(prompt_len):
        logits, cache = step(params, cache, prompt_tokens[:, i : i + 1])

    out = []
    _sync(device)
    t0 = time.perf_counter()
    tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    for _ in range(gen_len):
        out.append(tok)
        logits, cache = step(params, cache, tok)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    _sync(device)
    dt = time.perf_counter() - t0
    return torch.cat(out, dim=1), gen_len / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help=">0: rolling-buffer sliding-window decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    params = MDL.init(cfg, torch.Generator(device=device).manual_seed(args.seed))
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.context))
    ).to(device)
    toks, sps = greedy_generate(cfg, params, prompts, args.gen, window=args.window)
    assert toks.shape == (args.batch, args.gen)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log("serve", arch=cfg.name, batch=args.batch, context=args.context,
        generated=args.gen, decode_steps_per_s=round(sps, 2))
    return toks


if __name__ == "__main__":
    main()
