"""Batched serving engine: prefill + greedy/temperature decode over a cache.

Counterpart of ``repro.serve.engine``.  The prefill feeds the whole prompt
through ``LM.decode_step`` on a zeroed cache, as the JAX engine does, and
takes its first token greedily; each later token comes from one decode
step, greedy at ``temperature <= 0``, else sampled from the softmax of
``logits / temperature`` with a ``torch.Generator`` seeded by ``seed`` on
the model's device.  Sampling cannot match ``jax.random`` bit for bit, so
only greedy decoding is compared with the JAX package.  Tokens stay on the
device until the end: no step waits for the host.

The engine opens spans (``obs.trace``): ``serve.prefill`` with ``batch``
(the engine's count of prefills, kept on the host), ``rows`` and
``prompt_len``; ``serve.decode`` with the ``batch`` of the last prefill and
``steps``, around a ``serve.decode_step`` for each step.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.registry import LM
from ..obs.trace import span


@dataclass
class ServeEngine:
    model: LM
    max_len: int = 512
    batches: int = field(default=0, init=False)  # prefills so far: the spans' batch identifier

    @torch.inference_mode()
    def prefill(self, prompts) -> tuple[torch.Tensor, object]:
        """prompts (B, S0) -> (first tokens (B, 1), the cache after them)."""
        prompts = np.asarray(prompts)
        self.batches += 1
        with span("serve.prefill", batch=self.batches, rows=prompts.shape[0], prompt_len=prompts.shape[1]):
            tokens = torch.as_tensor(prompts, dtype=torch.long, device=self.model.device)
            cache = self.model.init_cache(tokens.shape[0], self.max_len)
            logits, cache = self.model.decode_step(cache, tokens)
            return logits[:, -1:, :].argmax(dim=-1), cache

    @torch.inference_mode()
    def decode(self, tok: torch.Tensor, cache, n_steps: int, temperature: float = 0.0,
               seed: int = 0) -> torch.Tensor:
        """``n_steps`` decode steps from ``tok`` (B, 1) -> (B, n_steps)."""
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        out = []
        with span("serve.decode", batch=self.batches, steps=n_steps):
            for _ in range(n_steps):
                with span("serve.decode_step"):
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
