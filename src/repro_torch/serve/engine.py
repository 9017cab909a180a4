"""Batched serving engine: prefill + greedy/temperature decode over a cache.

Counterpart of ``repro.serve.engine``.  The prefill feeds the whole prompt
through ``LM.decode_step`` on a zeroed cache, as the JAX engine does, and
takes its first token greedily; each later token comes from one decode
step, greedy at ``temperature <= 0``, else sampled from the softmax of
``logits / temperature`` with a ``torch.Generator`` seeded by ``seed`` on
the model's device.  Sampling cannot match ``jax.random`` bit for bit, so
only greedy decoding is compared with the JAX package.  Tokens stay on the
device until the end: no step waits for the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.registry import LM


@dataclass
class ServeEngine:
    model: LM
    max_len: int = 512

    @torch.inference_mode()
    def prefill(self, prompts) -> tuple[torch.Tensor, object]:
        """prompts (B, S0) -> (first tokens (B, 1), the cache after them)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.model.device)
        cache = self.model.init_cache(tokens.shape[0], self.max_len)
        logits, cache = self.model.decode_step(cache, tokens)
        return logits[:, -1:, :].argmax(dim=-1), cache

    @torch.inference_mode()
    def decode(self, tok: torch.Tensor, cache, n_steps: int, temperature: float = 0.0,
               seed: int = 0) -> torch.Tensor:
        """``n_steps`` decode steps from ``tok`` (B, 1) -> (B, n_steps)."""
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        out = []
        for _ in range(n_steps):
            logits, cache = self.model.decode_step(cache, tok)
            logits = logits[:, -1, :]
            if temperature <= 0.0:
                tok = logits.argmax(dim=-1, keepdim=True)
            else:
                probs = torch.softmax(logits / max(temperature, 1e-4), dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            out.append(tok)
        return torch.cat(out, dim=1) if out else tok[:, :0]

    def generate(
        self,
        prompts,  # (B, S0) int
        n_steps: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """(B, n_steps) int32: the prefill's token, then ``n_steps - 1``
        decoded ones."""
        tok, cache = self.prefill(prompts)
        rest = self.decode(tok, cache, n_steps - 1, temperature, seed)
        return torch.cat([tok, rest], dim=1).to(torch.int32).cpu().numpy()
