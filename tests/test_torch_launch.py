"""The port's launch tools against the JAX package's, on the CPU.

``param_counts`` and ``model_flops`` must equal the reference's exactly for
every architecture and the three headline shapes. ``analyze_step``'s flops
are held to the reference's ``analyze_hlo`` on the compiled reduced yi-6b
prefill and decode step (flash switch off in both packages) within 1%: the
reached agreement is exact, since both count 2 * |result| * contraction of
the same products. Bytes are not compared: the port counts the elementwise
ops the reference leaves to the TPU's fusion (``step_analysis`` says why).
The kernel hook must count each wrapper call's analytic work exactly, and
nothing of the plain version it runs on the CPU. The plan CLI runs the
counterparts of the reference's CI ``plan-smoke`` jobs on the CPU.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.layers.attention as jattn
import repro_torch.layers.attention as tattn
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.model_flops import model_flops as jax_model_flops
from repro.launch.model_flops import param_counts as jax_param_counts
from repro.launch.roofline import roofline_terms as jax_roofline_terms
from repro.models import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro_torch import kernels
from repro_torch.bridge import decoder_lm_from_arrays
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.device import H100Target
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.qmatmul import ops as qmatmul_ops
from repro_torch.launch.model_flops import model_flops, param_counts
from repro_torch.launch.roofline import roofline_terms, summarize
from repro_torch.launch.step_analysis import Stats, analyze_step
from repro_torch.models import SHAPES
from repro_torch.plan.__main__ import main as plan_main

FLOPS_RTOL = 0.01
HEADLINE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference(arch):
    got = param_counts(get_config(arch))
    assert got == jax_param_counts(jax_get_config(arch))
    assert got[1] <= got[0]


@pytest.mark.parametrize("shape", HEADLINE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    got = model_flops(get_config(arch), SHAPES[shape])
    assert got == jax_model_flops(jax_get_config(arch), JAX_SHAPES[shape])
    assert got > 0


@pytest.fixture(scope="module")
def yi(monkeypatch_module):
    """The reduced yi-6b in both packages on the reference's weights, the
    flash switch off in both."""
    monkeypatch_module.setattr(jattn, "USE_FLASH_KERNEL", False)
    monkeypatch_module.setattr(tattn, "USE_FLASH_KERNEL", False)
    jcfg = jax_reduced_config("yi_6b")
    jm = jax_build_model(jcfg)
    params = init_params(jax.random.PRNGKey(0), jm.param_specs())
    model = decoder_lm_from_arrays(reduced_config("yi_6b"),
                                   jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, jm, params, model


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _hlo_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_step_flops_match_the_hlo_analysis(yi, step):
    jcfg, jm, params, model = yi
    rng = np.random.default_rng(0)
    if step == "prefill":
        tok = rng.integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
        want = _hlo_flops(jm.forward, params, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            _, st = analyze_step(model.forward,
                                 {"tokens": torch.from_numpy(tok).long()})
    else:
        B, L, pos = 2, 64, 7
        tok = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
        state = init_params(jax.random.PRNGKey(0),
                            jm.decode_state_specs(B, L))
        want = _hlo_flops(jm.decode_step, params, state, jnp.asarray(tok),
                          pos)
        with torch.no_grad():
            _, st = analyze_step(model.decode_step, model.decode_state(B, L),
                                 torch.from_numpy(tok), pos)
    assert want > 0
    assert st.flops == pytest.approx(want, rel=FLOPS_RTOL)
    assert st.flops_by_dtype == {"fp32": st.flops}   # the CPU upcasts
    assert st.bytes > 0 and st.collective_bytes == 0
    assert st.kernel_launches == {}


def test_quantized_decode_step_counts_each_qmatmul_call():
    """A quantized step on the CPU reports each qmatmul call as the card
    launches it: the head and every layer's down projection."""
    cfg = reduced_config("yi_6b").with_(quantized=True, quantized_mlp=True)
    model = decoder_lm_from_arrays(
        cfg, jax.tree.map(np.asarray, init_params(
            jax.random.PRNGKey(0),
            jax_build_model(jax_reduced_config("yi_6b")).param_specs())),
        device="cpu")
    with torch.no_grad():
        _, st = analyze_step(model.decode_step, model.decode_state(2, 32),
                             torch.tensor([3, 5], dtype=torch.int32), 4)
    assert st.kernel_launches == {"qmatmul": cfg.n_layers + 1}
    assert st.flops_by_dtype["int8"] > 0
    assert kernels.active_analysis is None


def _qmatmul_call(dx, dw, out, bias):
    rng = np.random.default_rng(1)
    M, K, N = 5, 48, 24
    x = torch.from_numpy(rng.integers(-100, 100, (M, K)).astype(dx))
    w = torch.from_numpy(rng.integers(-100, 100, (K, N)).astype(dw))
    b = (torch.from_numpy(rng.integers(-99, 99, (N,)).astype(np.int32))
         if bias else None)
    work = qmatmul_ops.work(M, K, N, x.dtype, w.dtype, out, bias)
    return "qmatmul", work, lambda: qmatmul_ops.qlinear(
        x, w, b, shift=6, out_dtype=out)


def _flash_call(dtype, causal):
    gen = torch.Generator().manual_seed(2)
    BH, S, hd = 3, 24, 16
    q, k, v = (torch.randn((BH, S, hd), generator=gen).to(dtype)
               for _ in range(3))
    work = flash_ops.work(BH, S, S, hd, dtype, causal)
    return "flash_attention", work, lambda: flash_ops.flash_attention(
        q, k, v, causal=causal)


@pytest.mark.parametrize("call", [
    ("int8", "int8", "int8", True), ("int16", "int8", "int16", False),
    ("int16", "int16", "int8", True), (torch.bfloat16, True),
    (torch.float32, False)], ids=str)
def test_hook_counts_the_kernels_analytic_work(call):
    name, work, fn = (_qmatmul_call(*call) if len(call) == 4
                      else _flash_call(*call))
    _, st = analyze_step(fn)
    assert st.kernel_launches == {name: 1}
    assert st.flops == work.ops
    assert st.flops_by_dtype == {work.dtype: work.ops}
    assert st.bytes == work.bytes      # the plain version adds nothing
    assert kernels.active_analysis is None


def test_qmatmul_work_reads_each_operand_at_its_width():
    w8 = qmatmul_ops.work(4, 4096, 64000, torch.int8, torch.int8, "int16",
                          False)
    w16 = qmatmul_ops.work(4, 11008, 4096, torch.int16, torch.int8, "int16",
                           False)
    assert w8.bytes == 4 * 4096 + 4096 * 64000 + 4 * 64000 * 2
    assert w16.bytes == 4 * 11008 * 2 + 11008 * 4096 + 4 * 4096 * 2
    assert w16.ops == 2.0 * 4 * 11008 * 4096 and w16.dtype == "int8"


@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm", "conv1d",
                                "conv_transpose1d"])
def test_product_flops(op):
    """2 * |result| * contraction per product, classed by operand dtype."""
    a, b = torch.ones(6, 5), torch.ones(5, 4)
    ab, bb = torch.ones(3, 6, 5), torch.ones(3, 5, 4)
    x, w = torch.ones(2, 4, 10), torch.ones(8, 4, 3)     # C_in 4, C_out 8
    fn, want = {
        "mm": (lambda: a @ b, 2 * 6 * 4 * 5),
        "addmm": (lambda: torch.addmm(torch.ones(4), a, b), 2 * 6 * 4 * 5),
        "bmm": (lambda: ab @ bb, 2 * 3 * 6 * 4 * 5),
        "baddbmm": (lambda: torch.baddbmm(torch.ones(3, 6, 4), ab, bb),
                    2 * 3 * 6 * 4 * 5),
        "conv1d": (lambda: torch.nn.functional.conv1d(x, w),
                   2 * (2 * 8 * 8) * (4 * 3)),
        "conv_transpose1d": (lambda: torch.nn.functional.conv_transpose1d(
            x, torch.ones(4, 8, 3)), 2 * (2 * 4 * 10) * (8 * 3)),
    }[op]
    st = analyze_step(fn)[1]
    assert st.flops == want and st.flops_by_dtype == {"fp32": want}
    with torch.no_grad():     # composite ops reach the mode undecomposed
        assert analyze_step(fn)[1].flops == want


def _bytes_of(fn, *args):
    return analyze_step(fn, *args)[1].bytes


@pytest.mark.parametrize("case", ["views", "elementwise", "inplace",
                                  "indexed_read", "indexed_write", "copy"])
def test_bytes_count_what_an_eager_op_moves(case):
    x = torch.zeros(64, 32)                          # 8 KiB of fp32
    idx = torch.tensor([1, 5, 9])                     # 24 bytes
    if case == "views":
        got = _bytes_of(lambda: x.view(32, 64).t()[3:].expand(2, 61, 32)
                        .transpose(0, 1).reshape(61, 2, 32))
        assert got == 0
    elif case == "elementwise":
        assert _bytes_of(lambda: x * x + 1) == 4 * 8192  # x read once
    elif case == "inplace":
        assert _bytes_of(lambda: x.add_(1.0)) == 2 * 8192
    elif case == "indexed_read":
        assert _bytes_of(lambda: x[idx]) == 24 + 2 * 3 * 32 * 4
    elif case == "indexed_write":
        rows = torch.ones(3, 32)
        got = _bytes_of(lambda: x.index_put_((idx,), rows, accumulate=True))
        assert got == 24 + 3 * 128 + 2 * 3 * 128
    else:
        got = _bytes_of(lambda: x[:, :4].copy_(torch.ones(64, 4)))
        assert got == 2 * 64 * 4 * 4 + 64 * 4 * 4   # ones written, read


def test_roofline_terms_keep_the_reference_keys_with_h100_peaks():
    gpu = H100Target()
    assert (gpu.peak("bf16"), gpu.peak("fp16"), gpu.peak("fp8"),
            gpu.peak("int8"), gpu.peak("tf32"), gpu.peak("fp32")) == (
        989e12, 989e12, 1979e12, 1979e12, 495e12, 67e12)
    assert (gpu.hbm_bw, gpu.hbm_bytes, gpu.nvlink_bw) == (3.35e12, 80e9,
                                                          900e9)
    with pytest.raises(ValueError, match="no H100 peak"):
        gpu.peak("fp4")
    st = Stats(flops=3e12, bytes=6.7e9,
               flops_by_dtype={"bf16": 1.978e12, "fp32": 1.022e12})
    out = roofline_terms(st, 1, 2e12, measured_s=0.05)
    want = jax_roofline_terms(Stats(flops=3e12, bytes=6.7e9), 1, 2e12)
    assert set(want) <= set(out)
    assert out["compute_s"] == pytest.approx(1.978e12 / 989e12
                                             + 1.022e12 / 67e12)
    assert out["memory_s"] == pytest.approx(6.7e9 / 3.35e12)
    assert out["dominant"] == "compute" and out["collective_s"] == 0
    assert out["step_time_bound_s"] == out["compute_s"]
    assert out["measured_over_bound"] == pytest.approx(0.05
                                                       / out["compute_s"])
    assert out["useful_flops_ratio"] == pytest.approx(2 / 3)
    line = summarize({"arch": "yi-6b", "shape": "prefill", "mesh": "1xH100",
                      "roofline": out})
    assert "dom=compute" in line and "measured=50.00ms" in line


@pytest.mark.parametrize("arch, flags", [
    ("yi-6b", ["--out"]), ("zamba2-2.7b", ["--quantized"])])
def test_plan_cli_warm_check(arch, flags, tmp_path, capsys):
    out = tmp_path / "plan.json"
    argv = ["--arch", arch, "--debug", "--device", "cpu", "--warm", *flags]
    if "--out" in flags:
        argv.append(str(out))
    assert plan_main(argv) == 0
    text = capsys.readouterr().out
    assert "=> OK" in text and "builds 2 -> 2" in text
    if "--out" in flags:
        d = json.loads(out.read_text())
        assert d["arch"] == "yi-6b" and d["cache"]["hits"] >= 2


@pytest.mark.parametrize("flag", [["--data", "2"], ["--model", "4"],
                                  ["--multi-pod"], ["--stages", "2"]],
                         ids=lambda f: f[0])
def test_plan_cli_mesh_flags_raise_naming_item_2(flag, tmp_path, capsys):
    """The reference's mesh flags: a mesh larger than the world (one
    process here) raises the reference's count error before any model is
    allocated; ``--stages 2`` on the 1x1 mesh records the reference's
    PlaceStages fallback and still passes the warm check."""
    argv = ["--arch", "yi-6b", "--debug", "--device", "cpu", *flag]
    need = {"--data": 2, "--model": 4, "--multi-pod": 512}.get(flag[0])
    if need is not None:
        with pytest.raises(RuntimeError,
                           match=f"need {need} devices, have 1"):
            plan_main(argv)
        return
    out = tmp_path / "plan.json"
    assert plan_main([*argv, "--warm", "--out", str(out)]) == 0
    assert "=> OK" in capsys.readouterr().out
    d = json.loads(out.read_text())
    assert d["mesh"] == "debug:1x1" and d["pipeline_stages"] == 2
    place = [p for p in d["passes"] if p["pass"] == "PlaceStages"]
    assert place == [{"pass": "PlaceStages", "stages": 2, "stage_axis": None,
                      "fallback": "data axis (1 rows) cannot hold 2 equal "
                                  "stages"}]
