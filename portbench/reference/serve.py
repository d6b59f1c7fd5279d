"""The reference of batched greedy serving: one served call replayed in full.

A call served B prompts of P positions and then n_new greedy tokens. Its
served tokens are the argmax of the prompt's last position, a0, and the n_new
decode argmaxes out_0 .. out_{n-1}; decode step i ran at position P + i on
token a0 (i = 0) or out_{i-1}. The reference runs one forward over the B
rows of the prompt and the n_new fed tokens, in float32, and reads its
logits at positions P - 1 .. P + n_new - 1, each of which predicted one
served token. An expert layer dispatches the tokens in the groups the call
dispatched them: the prompts' B P tokens together, then each decode step's
B tokens.

`gaps` is the judgement: for each served token, how far its logit lies
below the reference's best logit at that position (0 where the token is the
reference's argmax). For the control (a lower precision in the program's
place), the token is the one the control's own logits put first.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from portbench.reference import model as M
from portbench.weights import make_group


def replay(spec: M.Spec, seed: int, model: str, prompt: Dict[str, torch.Tensor],
           fed: torch.Tensor, decode_positions: Optional[torch.Tensor],
           device, precision: str = "fp32",
           stats: Optional[dict] = None) -> torch.Tensor:
    """Logits (B, n + 1, V) at positions P - 1 .. P + n - 1 of the prompt
    followed by the n `fed` tokens (B, n). prompt: {"tokens": (B, P)} or a
    VLM's {"embeddings": (B, P, d), "positions": (3, B, P)};
    decode_positions: the fed tokens' (3, B, n) positions for M-RoPE (None:
    P + i)."""
    M.set_exact_matmuls()
    io = M.upcast(make_group(spec, seed, model, "io", device))
    B, n = fed.shape
    if spec.embeddings_in:
        P = prompt["embeddings"].shape[1]
        emb = torch.cat([prompt["embeddings"].float(),
                         io["embed"][fed.long()]], 1)
        inputs = {"embeddings": emb}
        pos = torch.cat([prompt["positions"].long(),
                         decode_positions.long()], 2)
    else:
        P = prompt["tokens"].shape[1]
        inputs = {"tokens": torch.cat([prompt["tokens"].long(),
                                       fed.long()], 1)}
        pos = torch.arange(P + n, device=fed.device)[None].expand(B, P + n)
    T = P + n
    rows = torch.arange(B * T, device=fed.device).view(B, T)
    groups = [rows[:, :P].reshape(-1)] + [rows[:, P + i] for i in range(n)]
    want = torch.zeros((B, T), dtype=torch.bool, device=fed.device)
    want[:, P - 1:] = True

    def layer(l):
        return M.upcast(make_group(spec, seed, model, f"layer{l}", device))

    out = M.forward_logits(spec, layer, io, inputs, pos, precision, groups,
                           want, stats)
    return out.view(B, n + 1, -1)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, n + 1): each token's logit below the reference's best there."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
