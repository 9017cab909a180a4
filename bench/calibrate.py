#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's compared numbers over many seeds, the
control's (the plain reference one precision down, fp8 products, in the
program's place), and the program with a fault planted underneath.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1,2,3] [--fault 1,2,3]

A training cell reads each seed's first steps, as a run's set-up takes
them, against the reference; ``--fault`` seeds run the program with half
of each batch left out, the loss the mean over the rest.  A serving cell
serves one cycle of its mix a seed (every prompt length, at the run's
load) and reads the widest logit gap of the requests a run checks; ``--fault`` seeds
alter one served token of each request where the decode produces it.
One JSON line a reading, on standard output and appended to
``chiprun_out/calibrate.jsonl``.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.feed import Feed  # noqa: E402

OUT = ROOT / "chiprun_out" / "calibrate.jsonl"


@contextlib.contextmanager
def half_batch():
    """The program's loss over the first half of each batch's rows."""
    from repro_torch.models.registry import LM

    loss = LM.loss
    LM.loss = lambda self, b: loss(self, {k: v[:v.shape[0] // 2] for k, v in b.items()})
    try:
        yield
    finally:
        LM.loss = loss


@contextlib.contextmanager
def altered_token():
    """Each decode call's third token of every request replaced by the next id."""
    from repro_torch.serve.engine import ServeEngine

    decode = ServeEngine.decode

    def wrong(self, tok, cache, n_steps, *a, **kw):
        out = decode(self, tok, cache, n_steps, *a, **kw).clone()
        out[:, min(2, out.shape[1] - 1)] = (out[:, min(2, out.shape[1] - 1)] + 1) % self.model.cfg.vocab
        return out

    ServeEngine.decode = wrong
    try:
        yield
    finally:
        ServeEngine.decode = decode


class Stopwatch:
    """Calls a function and keeps its seconds under a name."""

    def __init__(self):
        self.times = {}

    def __call__(self, name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        self.times[name] = time.perf_counter() - t
        return out


def train_readings(cell, seed: int, control: bool, fault: bool) -> dict:
    drv = harness.load_file(ROOT / "bench" / "traffic" / "train.py")
    feed = Feed(seed, cell.arch["vocab"])

    def program():
        step, state, params = drv.build(cell, seed)
        got = drv.first_steps(cell, seed, step, state, params, feed)
        del step, state, params
        harness.free_device(cell.device)
        return got

    watch = Stopwatch()
    got = watch("program_s", program)
    want = watch("reference_s", drv.reference_readings, cell, seed, feed)
    out = {"program": {k: v for k, (v, _) in drv.compare(got, want, cell).items()}, "losses": want["losses"],
           "worst": drv.worst_leaves(got, want)}
    if control:
        ctrl = watch("control_s", drv.reference_readings, cell, seed, feed, "fp8")
        out["control"] = {k: v for k, (v, _) in drv.compare(ctrl, want, cell).items()}
        out["control_worst"] = drv.worst_leaves(ctrl, want)
    if fault:
        with half_batch():
            bad = watch("fault_s", program)
        out["half_batch"] = {k: v for k, (v, _) in drv.compare(bad, want, cell).items()}
    return {**out, "times": watch.times}


def serve_readings(cell, seed: int, control: bool, fault: bool) -> dict:
    drv = harness.load_file(ROOT / "bench" / "traffic" / "serve.py")
    feed = Feed(seed, cell.arch["vocab"])

    def program():
        engine = drv.build(cell, seed)
        client = drv.Client(cell.traffic, feed)
        done = {}
        for b in range(cell.traffic["batches_per_cycle"]):
            ids, answers, served, _ = client.serve(engine, b)
            done[b] = (ids, answers, served)
        del engine
        harness.free_device(cell.device)
        return done

    def gaps(done, *args, **kw):
        picks = drv.sample(cell, seed, {b: (ids.shape[1], a) for b, (ids, a, _) in done.items()})
        return max(drv.reference_gaps(cell, seed, feed, picks, done, *args, **kw))

    watch = Stopwatch()
    done = watch("program_s", program)
    out = {"program": {"logit_gap": watch("reference_s", gaps, done)}}
    if control:
        out["control"] = {"logit_gap": watch("control_s", gaps, done, "fp8", control=True)}
    if fault:
        with altered_token():
            bad = watch("fault_s", program)
        out["altered_token"] = {"logit_gap": gaps(bad)}
    return {**out, "times": watch.times}


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", type=seeds, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, device=torch.device("cuda"))
    read = train_readings if cell.traffic["kind"] == "train" else serve_readings
    OUT.parent.mkdir(exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        line = {"cell": cell.name, "seed": seed,
                **read(cell, seed, seed in args.control, seed in args.fault),
                "seconds": time.perf_counter() - t, "card": torch.cuda.get_device_name()}
        print(json.dumps(line), flush=True)
        with open(OUT, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
