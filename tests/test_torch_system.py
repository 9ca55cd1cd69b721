"""The port's slice as a whole vs the JAX reference: the paper's models from
float weights to dequantized outputs, the weight bridge, and the import and
device guards of the package."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.paper_models import PAPER_MODELS
from repro.configs.paper_models import build_paper_model as jax_build
from repro_torch.bridge import emitted_model_from_arrays
from repro_torch.configs.paper_models import build_paper_model

ROOT = Path(__file__).resolve().parent.parent
BATCH = 16


@pytest.fixture(scope="module")
def jax_models():
    """Reference models, compiled once per module on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jax_build(name, batch=BATCH)
        return cache[name]
    return get


def _input(name, rows=BATCH, seed=0):
    f_in = PAPER_MODELS[name][1]
    return np.random.default_rng(seed).uniform(-1, 1, (rows, f_in)).astype(np.float32)


@pytest.mark.parametrize("name", list(PAPER_MODELS))
def test_paper_model_port_aie_equals_reference_x86(name, jax_models):
    jm = jax_models(name)
    tm = build_paper_model(name, batch=BATCH, device="cpu")
    x = _input(name)
    want = jm.predict(x, "x86")
    got = tm.predict(x, "aie")
    assert got.shape == (BATCH, PAPER_MODELS[name][2][-1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.predict(x, "x86").numpy(), want)
    assert tm.placements() == jm.placements()
    assert tm.tiles_used == jm.tiles_used <= 304


def _layer_arrays(jm):
    """A reference model's state as numpy, in the bridge's format."""
    return [dict(name=l.name, weight=np.asarray(l.weight),
                 bias=None if l.bias is None else np.asarray(l.bias),
                 srs_shift=l.srs_shift, relu=l.relu, out_dtype=l.out_dtype,
                 rounding=l.rounding, f_in=l.f_in, f_out=l.f_out)
            for l in jm.layers]


@pytest.mark.parametrize("name", ["mlp_7layer", "token_mlp_s16",
                                  "channel_mlp_s16"])
def test_bridge_runs_reference_weights(name, jax_models):
    """The reference's quantized arrays, carried across without the port's
    passes, give the reference's outputs through the port's execution."""
    jm = jax_models(name)
    tm = emitted_model_from_arrays(
        _layer_arrays(jm), in_shift=jm.in_shift, in_dtype=jm.in_dtype,
        out_shift=jm.out_shift, device="cpu")
    for seed, rows in ((1, BATCH), (2, 3)):
        x = _input(name, rows, seed)
        for mode in ("aie", "x86"):
            np.testing.assert_array_equal(tm.predict(x, mode).numpy(),
                                          jm.predict(x, "x86"))
    xq = np.random.default_rng(3).integers(
        -128, 128, (4, PAPER_MODELS[name][1])).astype(np.int8)
    np.testing.assert_array_equal(
        tm.predict(xq, "aie", quantize_input=False,
                   dequantize_output=False).numpy(),
        jm.predict(xq, "x86", quantize_input=False, dequantize_output=False))


def test_bridge_rejects_malformed_arrays(jax_models):
    layers = _layer_arrays(jax_models("mlp_7layer"))
    io = dict(in_shift=7, in_dtype="int8", out_shift=3, device="cpu")
    bad = [dict(layers[0], weight=layers[0]["weight"].astype(np.float32))]
    with pytest.raises(ValueError, match="int8/int16"):
        emitted_model_from_arrays(bad, **io)
    bad = [dict(layers[0], bias=layers[0]["bias"][:-1])]
    with pytest.raises(ValueError, match="bias shape"):
        emitted_model_from_arrays(bad, **io)
    bad = [{k: v for k, v in layers[0].items() if k != "srs_shift"}]
    with pytest.raises(KeyError, match="srs_shift"):
        emitted_model_from_arrays(bad, **io)
    with pytest.raises(ValueError):
        emitted_model_from_arrays([], **io)


def test_seven_layer_calibrated_mlp_matches_reference():
    """tests/test_system.py's 7-layer 512 MLP, calibrated, both packages."""
    import repro.core as jcore
    import repro_torch.core as tcore

    def build(core):
        rng = np.random.default_rng(0)
        layers = [core.DenseSpec(512, activation="relu",
                                 bias=rng.standard_normal(512) * 0.05)
                  for _ in range(7)]
        return core.build_mlp_graph(batch=8, f_in=512, layers=layers, seed=11)

    x = np.random.default_rng(5).uniform(-1, 1, (8, 512)).astype(np.float32)
    jm = jcore.compile_graph(build(jcore), jcore.CompileConfig(calib=x))
    tm = tcore.compile_graph(build(tcore), tcore.CompileConfig(calib=x),
                             device="cpu")
    want = jm.predict(x, "x86")
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(tm.predict(x, "aie").numpy(), want)
    assert tm.estimated_cycles(128) == jm.estimated_cycles(128)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_paper_model("mlp_7layer", batch=BATCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        emitted_model_from_arrays(
            [dict(name="d", weight=np.zeros((8, 8), np.int8), bias=None,
                  srs_shift=0, relu=False, out_dtype="int8",
                  rounding="half_up", f_in=8, f_out=8)],
            in_shift=7, in_dtype="int8", out_shift=7)


def test_import_loads_neither_jax_nor_reference():
    """Every module of the port imports without jax, without the reference
    package and without CUDA or Triton (kernels build at first launch);
    so does the multi-rank spawn helper of the sharded tests, whose ranks
    must not load JAX, and ``repro_torch.dist`` exports the activation
    context."""
    src = ROOT / "src"
    modules = sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (src / "repro_torch").rglob("*.py"))
    assert {"repro_torch.launch.serve", "repro_torch.plan.__main__",
            "repro_torch.launch.model_flops", "repro_torch.launch.roofline",
            "repro_torch.launch.step_analysis", "repro_torch.dist.sharding",
            "repro_torch.launch.mesh"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['_torch_dist_run']:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.dist as d\n"
        "assert {'sharding_ctx', 'current_ctx', 'shard_act',\n"
        "        'serving_grad_mode'} <= set(d.__all__)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "flash_scaling.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {n}"


def test_chip_smoke_fails_without_card():
    """No result line, and a failing exit, where there is no card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
