"""Serving traffic: batches of requests through the program's engine
(``serve.engine.ServeEngine`` over ``models.registry.LM``), closed loop,
one batch in flight: a client sends the next batch when the last one's
tokens are back on the host.

The engine serves one prompt length a batch, so the client groups requests
by prompt length.  A cycle is ``batches_per_cycle`` batches of ``requests``
requests: the prompt lengths are the quantiles at (k + 0.5) / K of a
log-normal of median ``prompt_median`` and shape ``prompt_sigma``, one a
batch, rounded to ``length_multiple``; each request's answer length is a
quantile of a log-normal of median ``answer_median`` and shape
``answer_sigma`` over the cycle's requests, capped at ``max_new_tokens``,
placed by a fixed permutation.  Every seed serves the same cycle: the seed
draws the prompt ids and the order of the batches within each cycle.  A
batch decodes until its longest answer is done (the engine's prefill gives
the first token, decode steps the rest); each request keeps its own answer.

The host's clock times each batch from the call of its prefill (the
device is idle then: the loop waited for the last batch) to its first
tokens on the host, where a server would stream them to the client; the
decode is queued after that.  ``ttft_p95_ms`` is the 95th percentile over
every request of the window of that time.  ``serve_tokens_per_s``, the
prompt and answer tokens of every whole batch over the whole window, is
measured too and reported where ``BENCHMARK.json`` names it for the cell.
Set-up serves one batch and then prefills every other length of the cycle,
which warms up every shape.  A traced run then profiles the prefills of one
more cycle, back to back.

Once the window has closed and the program's state is freed, a sample of
the finished requests drawn from the seed, with the longest among them, goes
through the plain reference's full forward over prompt and answer, one
request at a time; the number compared is the widest gap by which a served
token's logit lies below the reference's best at its position.
"""
from __future__ import annotations

import time
from statistics import NormalDist

import numpy as np
import torch

from bench import flops, harness, profiling
from bench.feed import SERVE, WARMUP, Feed
from bench.reference.common import exact_matmul
from bench.weights import derive, draw

SAMPLE_SALT = 0x5A4D
ORDER_SALT = 0x0D3E
LAYOUT_SEED = 0x1A70  # the answers' places in the cycle: the same for every seed


def quantiles(median: float, sigma: float, n: int) -> np.ndarray:
    """The n quantiles at (i + 0.5) / n of a log-normal."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return median * np.exp(sigma * z)


def cycle(mix: dict) -> tuple[list[int], np.ndarray]:
    """(each batch's prompt length, (K, requests) answer lengths) of a cycle."""
    K, R, m = mix["batches_per_cycle"], mix["requests"], mix["length_multiple"]
    prompts = [max(m, int(round(q / m)) * m) for q in quantiles(mix["prompt_median"], mix["prompt_sigma"], K)]
    answers = np.clip(np.round(quantiles(mix["answer_median"], mix["answer_sigma"], K * R)), 1,
                      mix["max_new_tokens"]).astype(np.int64)
    return prompts, answers[np.random.default_rng(LAYOUT_SEED).permutation(K * R)].reshape(K, R)


def order(mix: dict, seed: int, n: int) -> list[int]:
    """The cycle's batch of each of the run's first ``n`` batches."""
    K = mix["batches_per_cycle"]
    out: list[int] = []
    for c in range(-(-n // K)):
        out += np.random.default_rng(derive(seed, ORDER_SALT, c)).permutation(K).tolist()
    return out[:n]


def build(cell, seed: int):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.registry import LM
    from repro_torch.serve.engine import ServeEngine

    ref, mix = cell.reference, cell.traffic
    prompts, _ = cycle(mix)
    model = LM(ArchConfig(**cell.arch), draw(ref, ref.param_table(cell.arch), seed, cell.device))
    return ServeEngine(model, max_len=max(prompts) + mix["max_new_tokens"])


def serve_batch(engine, prompts: np.ndarray, new_tokens: int) -> tuple[np.ndarray, float]:
    """(served (B, new_tokens) on the host, ms from the call to the first
    tokens on the host)."""
    start = time.perf_counter()
    tok, cache = engine.prefill(prompts)
    first = tok.cpu()
    ttft_ms = (time.perf_counter() - start) * 1e3
    rest = engine.decode(tok, cache, new_tokens - 1)
    return torch.cat([first, rest.cpu()], dim=1).numpy(), ttft_ms


class Client:
    """The run's batches in order: batch ``i``'s prompt ids and the answer
    length of each of its requests."""

    def __init__(self, mix: dict, feed: Feed, purpose: int = SERVE):
        self.mix, self.feed, self.purpose = mix, feed, purpose
        self.prompts, self.answers = cycle(mix)
        self.order: list[int] = []

    def batch(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        if i >= len(self.order):
            self.order = order(self.mix, self.feed.seed, 2 * i + self.mix["batches_per_cycle"])
        k = self.order[i]
        return self.feed.ids(self.purpose, i, self.mix["requests"], self.prompts[k]), self.answers[k]

    def serve(self, engine, i: int):
        """Serves batch ``i``: (prompt ids, answer lengths, served tokens,
        ms to the first tokens)."""
        ids, answers = self.batch(i)
        return (ids, answers) + serve_batch(engine, ids, int(answers.max()))


def sample(cell, seed: int, done: dict) -> list[tuple[int, int]]:
    """(batch, row) of the requests the reference checks, drawn from the
    seed among the finished ones ``done`` {batch: (prompt length, answers)},
    with the longest request (prompt and answer) among them."""
    R = cell.traffic["requests"]
    keys = sorted(done)
    want = min(cell.workload["checked_requests"], len(keys) * R)
    longest = max(((b, r) for b in keys for r in range(R)), key=lambda br: done[br[0]][0] + done[br[0]][1][br[1]])
    picks = {longest}
    rng = np.random.default_rng(derive(seed, SAMPLE_SALT))
    for i in rng.permutation(len(keys) * R):
        if len(picks) >= want:
            break
        picks.add((keys[int(i) // R], int(i) % R))
    return sorted(picks)


def reference_gaps(cell, seed: int, feed: Feed, picks, done: dict, prec: str = "f32",
                   control: bool = False) -> list[float]:
    """For each picked request, the gap at each served position between the
    reference's best logit and that of the served token; with ``control``,
    of the token that the reference at ``prec`` puts first instead.  ``done``
    {batch: (prompt ids, answers (R,), served (R, n))}."""
    exact_matmul()
    ref = cell.reference
    W = draw(ref, ref.param_table(cell.arch), seed, cell.device)
    model = ref.Model(cell.arch)
    gaps = []
    for b, r in picks:
        ids, answers, served = done[b]
        P, n = ids.shape[1], int(answers[r])
        tokens = torch.from_numpy(np.concatenate([ids[r], served[r][:n - 1]])[None]).to(cell.device)
        toks = torch.from_numpy(served[r][None, :n]).to(cell.device)
        positions = list(range(P - 1, P + n - 1))
        want = model.logits_at(W, tokens, positions)
        if control:
            toks = model.logits_at(W, tokens, positions, prec).argmax(dim=-1)
        gap = want.max(dim=-1).values - want.gather(-1, toks[..., None].long())[..., 0]
        gaps += gap.flatten().tolist()
    return gaps


def warm_up(engine, client: Client) -> None:
    """One whole batch, then a prefill at every other length of the cycle."""
    ids, answers = client.batch(0)
    serve_batch(engine, ids, int(answers.max()))
    R = client.mix["requests"]
    for k, P in enumerate(client.prompts):
        if P != ids.shape[1]:
            tok, _ = engine.prefill(client.feed.ids(WARMUP, k + 1, R, P))
            tok.cpu()


def run(cell) -> harness.Outcome:
    mix, dev = cell.traffic, cell.device
    feed = Feed(cell.seed, cell.arch["vocab"])
    R = mix["requests"]
    engine = build(cell, cell.seed)
    warm_up(engine, Client(mix, feed, WARMUP))
    setup_s = time.perf_counter() - cell.t_start
    harness.log(cell, "set-up done: one batch served, every prompt length prefilled")

    client = Client(mix, feed)
    done, ttft_ms = {}, []
    t0 = time.perf_counter()
    while True:
        i = len(done)
        ids, answers, served, ms = client.serve(engine, i)
        done[i] = (ids, answers, served)
        ttft_ms.append(ms)
        if time.perf_counter() - t0 >= cell.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = harness.memory_peak(dev)
    n = len(done)
    per_request = np.repeat(np.asarray(ttft_ms), R)
    served_tokens = sum(int(ids.shape[1] * R + answers.sum()) for ids, answers, _ in done.values())
    harness.log(cell, f"window done: {n} batches in {window_s:.3f} s; time to first token ms min "
                      f"{min(ttft_ms):.2f} median {np.median(ttft_ms):.2f} max {max(ttft_ms):.2f}")

    context, summary = {}, None
    if cell.trace:
        lens = client.prompts

        def prefills():
            for k, P in enumerate(lens):
                engine.prefill(feed.ids(SERVE, n + k, R, P))

        summary = profiling.traced(prefills, dev)
        context = {"arch": cell.arch, "mix": mix, "kind": "serve", "prefill": summary, "prefill_lens": lens,
                   "prefill_flops": sum(flops.prefill_flops(cell.arch, R, P) for P in lens)}
        harness.log(cell, f"traced the prefills of one cycle ({len(lens)} lengths)")
    del engine
    harness.free_device(dev)
    picks = sample(cell, cell.seed, {b: (ids.shape[1], answers) for b, (ids, answers, _) in done.items()})
    gaps = reference_gaps(cell, cell.seed, feed, picks, done)
    harness.log(cell, f"reference done: {len(picks)} requests, {len(gaps)} served tokens")
    return harness.Outcome(
        end_to_end={"ttft_p95_ms": float(np.percentile(per_request, 95)), "setup_s": setup_s,
                    "serve_tokens_per_s": served_tokens / window_s},
        attempted=n * R, failed=0, checks={"logit_gap": (max(gaps), cell.workload["limits"]["logit_gap"])},
        memory_peak_bytes=peak, context=context, summary=summary)
