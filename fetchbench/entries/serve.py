"""Entry kind ``serve``: a closed loop of batched greedy generation
through the port's ``launch.serve_lm.serve``: prefill a batch of prompts,
then decode token by token through the KV cache.

Set-up draws the weights from the seed and makes one call on a batch of
its own, which builds every kernel; the window makes call after call, each
on a new batch of prompts from the seed.  The comparison takes a sample of
the window's calls, drawn from the seed, the last among them, and holds
each served token, and the logits that chose each call's last one,
against the reference's full forward over the prompt and the served
tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from fetchbench import harness, reference
from fetchbench.traffic import prompts


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device,
                 traced: bool):
        from repro_torch.launch import serve_lm

        self.serve = serve_lm.serve
        self.cfg, self.wl, self.seed = cell.config, cell.workload, seed
        self.device = device
        fam = self.fam = reference.family(self.cfg, cell.root)
        self.model_cfg = harness.arch_config(self.cfg, fam)
        self.spec = fam.param_spec(self.cfg)
        harness.check_tree(self.model_cfg, self.spec)
        self.flat = fam.init_flat(self.spec, self.cfg, seed, device)
        self.params = harness.tree(fam.leaves(self.flat, self.spec))
        self.cache_dtype = fam.cache_dtype(self.cfg)
        self.calls: list[dict] = []
        self._call(0)                       # warm-up: builds every kernel
        self.calls = []

    def prompts(self, call: int) -> torch.Tensor:
        t = self.wl["traffic"]
        return prompts.batch(self.seed, call, t["batch"], t["prompt_len"],
                             self.cfg["vocab"])

    def _call(self, call: int) -> None:
        t = self.wl["traffic"]
        res = self.serve(self.model_cfg, self.params, self.prompts(call),
                         t["new_tokens"], self.device,
                         cache_dtype=self.cache_dtype)
        self.calls.append({"call": call, "tokens": res.tokens,
                           "logits": res.logits,
                           "prefill_s": res.prefill_s,
                           "decode_s": res.decode_s})

    def begin_window(self) -> None:
        self.calls = []

    def step(self) -> None:
        self._call(len(self.calls) + 1)

    def steps_attempted(self, n: int) -> int:
        return n * self.wl["traffic"]["batch"]

    def window_metrics(self, elapsed: float, n: int) -> dict:
        t = self.wl["traffic"]
        return {"serve_tokens_per_s": n * t["batch"] * t["new_tokens"]
                / elapsed}

    def layer_stats(self) -> dict:
        t = self.wl["traffic"]
        return {"calls": [{k: c[k] for k in ("prefill_s", "decode_s")}
                          for c in self.calls],
                "batch": t["batch"], "prompt_len": t["prompt_len"],
                "new_tokens": t["new_tokens"]}

    def release(self) -> None:
        del self.params, self.flat
        harness.free_device(self.device)

    def sample(self) -> list[dict]:
        """The last call and ``check_calls - 1`` others, drawn from the
        seed."""
        n = self.wl["check_calls"]
        rng = np.random.default_rng((self.seed, 7))
        others = self.calls[:-1]
        pick = rng.choice(len(others), size=min(n - 1, len(others)),
                          replace=False) if others else []
        return [others[i] for i in sorted(pick)] + self.calls[-1:]

    def check(self) -> dict:
        flat = self.fam.init_flat(self.spec, self.cfg, self.seed,
                                  self.device)
        P = self.fam.leaves(flat, self.spec)
        out = {"token_gap": 0.0, "logit_err": 0.0}
        for c in self.sample():
            ref = served_logits(self.fam, P, self.prompts(c["call"]),
                                c["tokens"], self.cfg)
            for k, v in gaps(ref, c["tokens"], c["logits"]).items():
                out[k] = max(out[k], v)
            del ref
        return out


def served_logits(fam, P: dict, prompt: torch.Tensor, served: torch.Tensor,
                  cfg: dict, **lowp) -> torch.Tensor:
    """The reference's logits (B, T, V) at the T positions that chose the
    served tokens: the prompt's last and each served token's but the
    last; ``fam`` the configuration's reference family."""
    seq = torch.cat([prompt.to(served.device), served[:, :-1]], dim=1)
    return fam.serve_logits(P, seq, prompt.shape[1] - 1, cfg, **lowp)


def gaps(ref: torch.Tensor, served: torch.Tensor, last: torch.Tensor
         ) -> dict:
    """The compared numbers of one call, against the reference's logits
    ``ref`` (B, T, V) at the served positions: ``token_gap``, the widest
    gap by which a served token's logit lies below the reference's best at
    its position; ``logit_err``, by the worst request, the largest
    distance of the logits that chose its last token (B, V) from the
    reference's there, over the largest of the reference's."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, served[..., None].to(ref.device))[..., 0]
    want = ref[:, -1]
    err = (last.to(ref.device, torch.float32) - want).abs().amax(-1) \
        / want.abs().amax(-1)
    return {"token_gap": float((best - got).max()),
            "logit_err": float(err.max())}
