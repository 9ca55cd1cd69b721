"""No run loads JAX or the JAX package ``repro``, and the reference loads
nothing of the program ``repro_torch``: whole top-level module names are
compared, since ``repro_torch`` begins with ``repro``."""

import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

RUN_A_CELL = r"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import importlib
from portbench.harness import cells, main
bench = Path({bench!r})
for p in sorted(Path({root!r}, "portbench").rglob("*.py")):
    rel = p.relative_to({root!r}).with_suffix("")
    if "tests" in rel.parts:
        continue
    if rel.parts[1] in ("drivers", "metrics") and not rel.name.startswith("_"):
        cells._module(p, "probe_" + rel.name.replace(".", "_"))
    elif rel.name != "run" and rel.name != "control":
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
line, _ = main.execute(bench, "yi6b-prefill-2k", 5, 0.5, False,
                       time.perf_counter(), device="cpu")
print(json.dumps({{"correct": line["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [{root!r}]
import torch
from portbench.harness.weights import reference_weights
from portbench.reference import lm, precision
cfg = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4,
           num_key_value_heads=2, head_dim=8, num_hidden_layers=2,
           vocab_size=64, rms_norm_eps=1e-6, rope_theta=1e4)
W = reference_weights(cfg, 3, "cpu")
t = torch.randint(0, 64, (2, 16))
for prec in (precision.FP32, precision.Precision("fp8")):
    lm.head(W, lm.hidden(W, cfg, t, prec), prec)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax(tiny_bench):
    got = json.loads(_run(RUN_A_CELL.format(root=str(ROOT),
                                            bench=str(tiny_bench))))
    assert got["correct"]
    assert "repro_torch" in got["top"]         # the program did run
    for banned in ("jax", "jaxlib", "flax", "repro"):
        assert banned not in got["top"]


def test_the_reference_loads_no_program():
    top = json.loads(_run(REFERENCE_ONLY.format(root=str(ROOT))))
    assert "torch" in top
    for banned in ("repro_torch", "repro", "jax"):
        assert banned not in top
