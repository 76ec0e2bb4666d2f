"""Batched serving driver: prefill + greedy decode with the production cache.

The port of the JAX package's ``launch/serve.py``: the same steps
(``make_prefill_step`` / ``make_serve_step``), the same result dict, random
weights from ``seed``.  On the card, prefill runs the hand-written kernels
(flash attention, RG-LRU scan, SSD chunked forward); decode runs plain torch,
as the JAX package's decode runs no kernel either.

  python -m repro_torch.launch.serve --arch recurrentgemma-2b --full \\
      --batch 4 --prompt-len 4096 --gen 32 [--int8-kv] [--device cpu]

Without ``--full`` it serves the architecture's smoke config.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device, sync
from repro_torch.launch.specs import make_prefill_step, make_serve_step
from repro_torch.models.model import build_model, tree_leaves


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, int8_kv: bool = False,
          seed: int = 0, device=None):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens (after
    ``n_img_tokens`` random image embeddings for a vlm config; with
    ``enc_seq`` random frame embeddings for an encdec config, which the
    cache does not hold) and generate ``gen`` tokens each.  Returns
    {generated (B, gen) int32 array, prefill_s, decode_s, tok_per_s,
    cache_bytes}."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if int8_kv:
        cfg = cfg.replace(kv_cache_dtype="int8")
    model = build_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(g)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=dev)
    batch_in = {"tokens": prompts}
    if cfg.family == "encdec":
        batch_in["frames"] = torch.randn(
            (batch, cfg.enc_seq, cfg.d_model), generator=g, device=dev)
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    if n_img:
        batch_in["image_embeds"] = torch.randn(
            (batch, n_img, cfg.vision_embed_dim), generator=g, device=dev)

    prefill_step = make_prefill_step(model)
    serve_step = make_serve_step(model)

    cache = model.init_cache(batch, prompt_len + gen + n_img)
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch_in, cache)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [nxt]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        nxt, cache = serve_step(params, cache, nxt)
        out.append(nxt)
    sync(dev)
    t_decode = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1)
    return {
        "generated": tokens.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for _, t in tree_leaves(cache["groups"])),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config (the card's normal mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    r = serve(args.arch, smoke=not args.full, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              int8_kv=args.int8_kv, device=args.device)
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} int8_kv={args.int8_kv} device={args.device}")
    print(f"prefill: {r['prefill_s']*1e3:.1f} ms   "
          f"decode: {r['decode_s']*1e3:.1f} ms "
          f"({r['tok_per_s']:.1f} tok/s)   cache={r['cache_bytes']/2**20:.1f} MiB")
    print("first sequences:", r["generated"][:2, :8].tolist())


if __name__ == "__main__":
    main()
