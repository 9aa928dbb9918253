"""Batched serving with the PyTorch port: prefill a batch of prompts, then
decode with the serve step (KV/SSM caches), greedy sampling.

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch falcon_mamba_7b] [--device cpu]

The port's counterpart of ``examples/serve_batched.py``, at the arch's
smoke config with seeded random weights; on the card unless ``--device
cpu`` is given.  The continuous-batching engine is
``python -m repro_torch.launch.serve``.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.model import transformer as T  # noqa: E402
from repro_torch.model.layers import device_of  # noqa: E402


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = device_of(args.device)
    cfg = get_arch(args.arch).smoke()
    params = T.init_params(cfg, seed=args.seed, device=dev)
    b, pl_, max_len = args.batch, args.prompt_len, args.prompt_len + args.gen
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(2, cfg.vocab, (b, pl_), generator=gen, device=dev)

    t0 = time.time()
    logits, pre_cache = T.prefill(params, cfg, prompts)
    print(f"prefill {b}×{pl_}: {time.time() - t0:.2f}s (logits {tuple(logits.shape)})")

    # widen the prefill cache to max_len: its rows (or states) at the front
    cache = T.init_cache(cfg, b, max_len, device=dev)
    for lc, pc in zip(cache, pre_cache):
        for name, t in lc.items():
            t[:, :pc[name].shape[1]] = pc[name].to(t.dtype)

    tok = logits.argmax(-1)[:, None]
    out_tokens = [tok]
    t0 = time.time()
    for i in range(args.gen - 1):
        logits_i, cache = T.decode_step(params, cfg, tok, cache, pl_ + i)
        tok = logits_i.argmax(-1)[:, None]
        out_tokens.append(tok)
    tokens = torch.cat(out_tokens, 1)
    dt = time.time() - t0
    print(f"decoded {args.gen - 1} steps × {b} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * b / max(dt, 1e-9):.1f} tok/s, smoke config on {dev.type})")
    print("sample tokens:", tokens[0][:12].tolist())
    return tokens


if __name__ == "__main__":
    main()
