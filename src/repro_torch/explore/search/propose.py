"""Model-guided candidate proposal: local search over the space DSL.

After the halving ladder has spent most of its budget, the best known configs
define promising neighborhoods.  :class:`LocalSearch` perturbs their *raw*
axis dicts one axis-step at a time (:meth:`repro_torch.explore.space.SearchSpace.neighbors`),
screens the never-seen proposals with the same cheap models, and promotes the
best few for full estimation — a TPE-flavored exploitation loop that generates
candidates lazily instead of enumerating the cross-product.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LocalSearch:
    """Perturbation proposal loop riding on a :class:`SuccessiveHalving` run.

    ``rounds``: proposal rounds after the initial halving pass.
    ``top_k``: how many of the current best full estimates seed each round.
    ``promote``: full estimations spent per round (reserved out of the overall
    search budget; ``rounds * promote`` is the loop's total spend).
    """

    rounds: int = 2
    top_k: int = 4
    promote: int = 4

    def __post_init__(self):
        if self.rounds < 1 or self.top_k < 1 or self.promote < 1:
            raise ValueError(
                f"LocalSearch(rounds={self.rounds}, top_k={self.top_k}, "
                f"promote={self.promote}): all parameters must be >= 1"
            )

    @property
    def reserve(self) -> int:
        """Full-estimation budget the proposal loop claims."""
        return self.rounds * self.promote

    def propose(self, space, seeds: list[dict], seen: set, key_fn) -> list[tuple]:
        """New ``(raw, cfg)`` proposals: feasible one-step neighbors of the
        seed raw dicts, deduplicated against everything already considered."""
        out: list[tuple] = []
        for raw in seeds:
            for nb in space.neighbors(raw):
                cfg = space.accept(nb)
                if cfg is None:
                    continue
                key = key_fn(cfg)
                if key in seen:
                    continue
                seen.add(key)
                out.append((nb, cfg))
        return out
