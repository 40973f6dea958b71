"""LM serving launcher: prefill + batched greedy decode with KV caches.

Counterpart of ``repro.launch.serve``, with the same flags and output line
plus ``--device`` (default: the card, which raises without a GPU; ``cpu``
runs the same code on the host).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        [--smoke] [--batch 4] [--prompt-len 64] [--gen 32] [--device cpu]

Every registered arch serves. For the audio family (whisper-base) the
encoder takes ``--prompt-len`` zero frame embeddings, as the reference's
CLI does.

Weights are random, drawn on the target device from seed 0 (the prompt
from seed 1): a truncated-normal init of billions of parameters on the
host would take minutes.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import reduced_for_smoke
from repro_torch.configs.registry import get_config
from repro_torch.models.model import build_model


def generate(model, params, prompt, *, gen: int, enc_seq=None):
    """Greedy generation loop with a persistent KV cache: the first token
    from the prefill's logits, then ``gen - 1`` decode steps at index
    ``P + i``. The audio family encodes ``enc_seq`` zero frame embeddings
    first. Returns (B, gen) int32 token ids."""
    B, P = prompt.shape
    dev = prompt.device
    dtype = getattr(torch, model.cfg.dtype)
    audio = model.cfg.family == "audio"
    cache = model.init_cache(B, P + gen, enc_seq if audio else None, device=dev)
    batch = {"tokens": prompt}
    if audio:
        batch["frame_embeds"] = torch.zeros((B, enc_seq, model.cfg.d_model),
                                            dtype=dtype, device=dev)
    if model.cfg.family == "vlm":
        nv = min(4, P)
        batch["vision_embeds"] = torch.zeros((B, nv, model.cfg.d_model),
                                             dtype=dtype, device=dev)
        batch["positions3"] = torch.arange(P, dtype=torch.int32, device=dev
                                           )[None, None, :].expand(3, B, P)

    logits, cache = model.prefill(params, batch, cache)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out = [token]
    for i in range(gen - 1):
        db = {"token": token, "index": P + i}
        if model.cfg.family == "vlm":
            db["positions3"] = torch.full((3, B, 1), P + i, dtype=torch.int32,
                                          device=dev)
        logits, cache = model.decode_step(params, cache, db)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(token)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg).scaled(dtype="float32")
    model = build_model(cfg, max_seq=args.prompt_len + args.gen,
                        chunk=min(512, args.prompt_len))
    with torch.inference_mode():
        params = model.init_params(torch.Generator(device).manual_seed(0), device)
        prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                               generator=torch.Generator(device).manual_seed(1),
                               device=device)
        t0 = time.perf_counter()
        tokens = generate(model, params, prompt, gen=args.gen,
                          enc_seq=args.prompt_len).cpu()
        dt = time.perf_counter() - t0
    n = args.batch * args.gen
    print(f"[serve] generated {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s); sample: {tokens[0, :16].numpy()}")


if __name__ == "__main__":
    main()
