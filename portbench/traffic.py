"""The one generator of the benchmark's inputs: every batch and every
prompt comes from a cell file's parameters and the seed, made on the
device, the same for the program and for the reference.

A cell file's "traffic" says what a row is:

- "seq": the row's length (training) or "prompt" its prompt length
  (serving);
- "image": [t, h, w], the merged patch grid of one image at the start of
  the row (a VLM), or absent. Its t h w positions take N(0, 1) patch
  embeddings; the text after it takes its tokens' rows of the model's
  token table. M-RoPE positions are laid out as Qwen2-VL's
  `get_rope_index` lays them: the image's (t0 + i, h0 + j, w0 + k), then
  each text token one past the largest position so far, in all three
  streams;
- "zipf": the exponent s of the law P(id) ~ 1 / (id + 1)^s over the
  vocabulary from which token ids are drawn.

Training labels are each position's next token, and for an image's
positions a draw from the same law. Batch k of a run and call c's prompts
each have a generator of their own, seeded from (seed, k) or (seed, c).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench.weights import group_seed


class Traffic:
    def __init__(self, traffic: dict, spec, seed: int, device,
                 table: Optional[torch.Tensor] = None):
        """`table`: the model's token table (V, d) for a VLM's text rows."""
        self.t = traffic
        self.spec = spec
        self.seed = seed
        self.device = torch.device(device)
        self.table = table
        p = 1.0 / torch.arange(1, spec.vocab + 1, dtype=torch.float64,
                               device=self.device) ** traffic["zipf"]
        self.cdf = torch.cumsum(p / p.sum(), 0)
        self.cdf[-1] = 1.0

    def _gen(self, kind: str, k: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            group_seed(self.seed, kind, str(k)))

    def _ids(self, gen, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=self.device,
                       dtype=torch.float64)
        return torch.searchsorted(self.cdf, u).clamp_(max=self.spec.vocab - 1)

    def _image(self):
        img = self.t.get("image")
        return (0, 0, 0) if not img else tuple(img)

    def positions(self, B: int, n_text: int) -> torch.Tensor:
        """(3, B, n_img + n_text) int64 M-RoPE positions of rows of one
        image then n_text text tokens."""
        t, h, w = self._image()
        dev = self.device
        if t * h * w:
            tt, hh, ww = torch.meshgrid(torch.arange(t, device=dev),
                                        torch.arange(h, device=dev),
                                        torch.arange(w, device=dev),
                                        indexing="ij")
            img = torch.stack([tt.reshape(-1), hh.reshape(-1),
                               ww.reshape(-1)])
            start = int(img.max()) + 1
        else:
            img = torch.zeros((3, 0), dtype=torch.int64, device=dev)
            start = 0
        txt = start + torch.arange(n_text, device=dev)
        pos = torch.cat([img, txt.expand(3, n_text)], 1)
        return pos[:, None].expand(3, B, pos.shape[1]).contiguous()

    def _rows(self, gen, B: int, S: int
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(inputs of B rows of S positions, the token draw whose shift by
        one gives the text positions' labels)."""
        t, h, w = self._image()
        n_img = t * h * w
        n_txt = S - n_img
        if not self.spec.embeddings_in:
            ids = self._ids(gen, (B, S + 1))
            return {"tokens": ids[:, :S]}, ids
        dt = getattr(torch, self.spec.dtype)
        img = torch.randn((B, n_img, self.spec.d), generator=gen,
                          device=self.device).to(dt)
        ids = self._ids(gen, (B, n_txt + 1))
        emb = torch.cat([img, self.table[ids[:, :n_txt]].to(dt)], 1)
        return ({"embeddings": emb, "positions": self.positions(B, n_txt)},
                ids)

    def train_batch(self, k: int) -> Dict[str, torch.Tensor]:
        """Batch k: inputs and (B, S) labels."""
        gen = self._gen("batch", k)
        B, S = self.t["batch"], self.t["seq"]
        out, ids = self._rows(gen, B, S)
        n_img = S - (ids.shape[1] - 1)
        img_labels = self._ids(gen, (B, n_img))
        out["labels"] = torch.cat([img_labels, ids[:, 1:]], 1)
        return out

    def decode_positions(self, B: int, P: int, n: int) -> torch.Tensor:
        """(3, B, n) M-RoPE positions of n generated tokens after a prompt
        of P positions: text, each one past the largest position so far,
        as Qwen2-VL continues a sequence."""
        t, h, w = self._image()
        n_txt = P - t * h * w
        last = int(self.positions(1, n_txt).max())
        pos = last + 1 + torch.arange(n, device=self.device)
        return pos.expand(3, B, n).contiguous()

    def prompts(self, c: int) -> Dict[str, torch.Tensor]:
        """Call c's prompts: B rows of the prompt length."""
        out, _ = self._rows(self._gen("call", c), self.t["batch"],
                            self.t["prompt"])
        return out
