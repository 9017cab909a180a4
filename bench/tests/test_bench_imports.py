"""Nothing that a run loads has the top-level name of JAX or of the JAX
package, and the references load nothing of the program: in a fresh
process, compared by whole top-level names."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
def top():
    return {{m.split(".")[0] for m in sys.modules}}
import bench.reference.common, bench.reference.dense, bench.reference.rwkv6
refs = sorted(top() & {{"repro_torch", "repro", "jax", "jaxlib", "flax"}})
from bench import harness
from bench.testing import smoke_cell
for name in ("olmo-1b.train_2k", "rwkv6-1.6b-variant.serve_code"):
    assert harness.run_cell(smoke_cell(name, seconds=0.05))["correct"]
run = sorted(top() & set(harness.FORBIDDEN))
print(json.dumps({{"refs": refs, "run": run, "program": "repro_torch" in top()}}))
"""


def test_no_jax_in_a_run_and_no_program_in_the_references():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"refs": [], "run": [], "program": True}
    assert "repro" not in {"repro_torch"}  # the check compares whole names: repro_torch is not repro
