"""Serving: batched prefill and greedy token-by-token decode.

Port of ``examples/serve_lm.py``: a (randomly initialized) model of the
zoo prefills a batch of prompts and greedily decodes continuations
through the KV and recurrent-state cache (``models.transformer``'s
``init_cache`` / ``prefill`` / ``decode_step``).  The command line runs
the reduced (smoke) config of an arch; :func:`serve` takes any config and
parameters.  whisper-small's batch carries frame embeddings and
pixtral-12b's patch embeddings (:func:`frontend_inputs`); the reference
example feeds zeros, the port standard-normal values from a seeded
``torch.Generator``.  The cache of a vision model holds its patch prefix
as well as the prompt and the new tokens (the reference example leaves
the prefix out of the cache's size, so its decode overwrites live slots).

On a CUDA device :func:`serve` runs the first decode step eagerly,
captures the next into a CUDA graph and replays that graph for the rest of
the call, so the host launches one graph a token instead of every op of
every layer; the CPU steps eagerly.  ``DECODE_STEPS`` counts the steps by
the path they ran on.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer

# decode steps by the path they ran on: replayed from a CUDA graph, or eager
DECODE_STEPS = {"graph": 0, "eager": 0}

# Per device, kept from call to call: the side stream of the decode's first
# step and its capture, since cuBLAS keeps a workspace for each stream it
# runs on; and the last graph captured, whose memory pool the next capture
# shares, since a pool of each call's own would stay reserved after its
# graph is gone.
_CAPTURE: dict = {}


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor    # (B, n_tokens) greedy continuation
    logits: torch.Tensor    # (B, V) logits that chose the last token
    cache: dict             # the cache after the last decode step
    prefill_s: float        # prefill seconds, ended by a device sync
    decode_s: float         # seconds per decode step, ended by a device sync


def frontend_inputs(cfg, batch: int, generator: torch.Generator) -> dict:
    """The stub frontend's inputs of ``batch`` requests, standard normal
    from ``generator`` (on the CPU): ``frames`` (batch, enc_seq, d) for an
    encoder-decoder, ``patches`` (batch, n_patches, d) for a vision model,
    nothing otherwise."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=generator)
    if cfg.frontend == "vision":
        out["patches"] = torch.randn((batch, cfg.n_patches, cfg.d_model),
                                     generator=generator)
    return out


def serve(cfg, params: dict, prompts: torch.Tensor, n_tokens: int,
          device=None, cache_dtype=torch.bfloat16, frames=None,
          patches=None) -> ServeResult:
    """Prefill ``prompts`` (B, S) and decode ``n_tokens`` greedy tokens:
    the first from the prefill's logits, the others from ``n_tokens - 1``
    decode steps.  ``params`` lie on ``device`` (``cuda`` unless asked
    otherwise).  An encoder-decoder takes ``frames`` (B, enc_seq, d), a
    vision model ``patches`` (B, P, d).  The cache is sized for
    ``P + S + n_tokens`` positions (a ring of the window's size if the
    config has a smaller sliding window) and holds k and v in
    ``cache_dtype`` (recurrent states are float32)."""
    device = resolve_device(device)
    prompts = prompts.to(device)
    B, S = prompts.shape
    batch = {"tokens": prompts}
    for key, x, needed in (("frames", frames, cfg.is_encdec),
                           ("patches", patches, cfg.frontend == "vision")):
        if needed and x is None:
            raise ValueError(f"{cfg.name} takes {key}")
        if needed:
            batch[key] = x.to(device)
    prefix = patches.shape[1] if "patches" in batch else 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        cache = transformer.init_cache(cfg, B, prefix + S + n_tokens,
                                       cache_dtype, device)
        sync()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(params, batch, cfg, cache)
        sync()
        prefill_s = time.perf_counter() - t0
        tok = logits.argmax(dim=-1, keepdim=True)
        t0 = time.perf_counter()
        graphed = device.type == "cuda" and n_tokens > 2
        if graphed:
            tokens = tok.new_empty((B, n_tokens))
            tokens[:, :1] = tok
            graph, static = capture_decode(params, tok, cfg, cache, tokens,
                                           prefix + S)
            for _ in range(n_tokens - 2):
                graph.replay()
            logits = static.clone()
            DECODE_STEPS["eager"] += 1
            DECODE_STEPS["graph"] += n_tokens - 2
        else:
            out = [tok]
            for _ in range(n_tokens - 1):
                logits, cache = transformer.decode_step(params, tok, cfg,
                                                        cache)
                tok = logits.argmax(dim=-1, keepdim=True)
                out.append(tok)
            tokens = torch.cat(out, dim=1)
            DECODE_STEPS["eager"] += n_tokens - 1
        sync()
        decode_s = (time.perf_counter() - t0) / max(n_tokens - 1, 1)
    if graphed:
        # The side stream's cuBLAS workspace would stay allocated beside
        # the caller's stream's through the next call's prefill; nothing
        # runs now, and each stream takes a workspace again when it next
        # calls cuBLAS.
        torch._C._cuda_clearCublasWorkspaces()
    return ServeResult(tokens, logits, cache, prefill_s, decode_s)


def capture_decode(params: dict, tok: torch.Tensor, cfg, cache: dict,
                   tokens: torch.Tensor, first: int):
    """The first decode step of a call, run eagerly, then the next one
    captured into a CUDA graph, which capture does not run: the
    embedding of ``tok`` (B, 1), every unit over ``cache`` (updated in
    place, ``pos`` advanced in place), the argmax written back into
    ``tok``, and that token written into ``tokens`` (B, n) at column
    ``pos - first`` by a device index, ``first`` being the first decode
    step's position (the prefill's length).  Each replay is then one more
    step.  Returns (the graph, its logits (B, V)), which hold the last
    replayed step's logits.  The graph reads ``params``, ``tok``,
    ``cache`` and ``tokens`` where they lie: the caller keeps them.

    The eager step is a real step and the warm-up that creates cuBLAS's
    lazy state; it runs on the side stream the capture uses.  The capture
    allocates from the pool of the device's last graph, which is never
    replayed again.  Under no autograd."""
    dev = tok.device

    def step():
        logits, _ = transformer.decode_step(params, tok, cfg, cache)
        tok.copy_(logits.argmax(dim=-1, keepdim=True))
        tokens.index_copy_(1, (cache["pos"] - first).long().reshape(1), tok)
        return logits

    side, last = _CAPTURE.get(dev) or (torch.cuda.Stream(dev), None)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        # capture_begin rather than torch.cuda.graph, whose entry empties
        # the allocator's cache: the next call's prefill would then
        # cudaMalloc its memory anew
        graph.capture_begin(pool=None if last is None else last.pool())
        try:
            logits = step()
        finally:
            graph.capture_end()
    _CAPTURE[dev] = side, graph
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph, logits


def main(argv=None, log=print) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=configs.list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch)      # reduced zoo variant
    params = transformer.init_params(cfg, seed=0, device=device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen)
    extra = frontend_inputs(cfg, args.batch, gen)
    res = serve(cfg, params, prompts, args.tokens, device, **extra)
    prefix = extra["patches"].shape[1] if "patches" in extra else 0
    log(f"{args.arch}: prefilled {args.batch}x{args.prompt_len} in "
        f"{res.prefill_s:.2f}s (cache pos {prefix + args.prompt_len})")
    log(f"decoded {args.tokens} tokens/seq at {res.decode_s * 1e3:.1f} "
        f"ms/token")
    for i, seq in enumerate(res.tokens.tolist()):
        log(f"  seq{i}: {seq}")
    return res


if __name__ == "__main__":
    main()
