"""The port's compiler passes vs the JAX package's, on the same graphs:
equal shifts, packed tensors, cascades, memory-tile edges and placements."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.cascade import resolve_cascade as j_resolve
from repro.core.device import NATIVE_TILINGS as J_TILINGS
from repro_torch.core.cascade import resolve_cascade as t_resolve
from repro_torch.core.device import NATIVE_TILINGS as T_TILINGS


def _mlp(core, batch=16, f_in=48, widths=(64, 32, 10), seed=3):
    rng = np.random.default_rng(7)
    layers = [core.DenseSpec(w, bias=rng.standard_normal(w) * 0.1,
                             activation="relu" if i + 1 < len(widths) else None)
              for i, w in enumerate(widths)]
    return core.build_mlp_graph(batch=batch, f_in=f_in, layers=layers, seed=seed)


def _seven_layer(core, batch=8):
    rng = np.random.default_rng(0)
    layers = [core.DenseSpec(512, activation="relu",
                             bias=rng.standard_normal(512) * 0.05)
              for _ in range(7)]
    return core.build_mlp_graph(batch=batch, f_in=512, layers=layers, seed=11)


def _token_mixer(core):
    layers = [core.DenseSpec(256, activation="relu"),
              core.DenseSpec(196, activation="relu")]
    return core.build_mlp_graph(batch=64, f_in=196, layers=layers, seed=2)


def _mixed(g):
    g["dense_1"].overrides["w_dtype"] = "int8"
    g["dense_0"].overrides["a_dtype"] = "int16"


def _overrides(g):
    g["dense_1"].overrides.update({"cas_len": 2, "cas_num": 2, "place": (10, 3)})


def _int16_weights(g):
    g["dense_0"].overrides["a_dtype"] = "int16"  # dense_1: int16 x int16
    g["dense_1"].overrides["w_dtype"] = "int16"


CALIB = np.random.default_rng(1).uniform(-1, 1, (16, 48)).astype(np.float32)

# name: (graph builder, graph edit, config kwargs)
CASES = {
    "mlp": (_mlp, None, {}),
    "mlp_calibrated": (_mlp, None, {"calib": CALIB}),
    "mixed_precision": (_mlp, _mixed, {}),
    "int16_weights": (_mlp, _int16_weights, {}),
    "user_overrides": (_mlp, _overrides, {}),
    "half_even_in_shift": (_mlp, None, {"rounding": "half_even", "in_shift": 6}),
    "paper_7layer": (_seven_layer, None, {}),
    "token_mixer": (_token_mixer, None, {}),
}


def _compile_both(case):
    build, edit, cfg = CASES[case]
    gj, gt = build(jcore), build(tcore)
    if edit is not None:
        edit(gj)
        edit(gt)
    mj = jcore.compile_graph(gj, jcore.CompileConfig(**cfg))
    mt = tcore.compile_graph(gt, tcore.CompileConfig(**cfg), device="cpu")
    return gj, gt, mj, mt


def _assert_same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same_value(a[k], b[k], f"{what}.{k}")
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("case", list(CASES))
def test_pass_artifacts_equal(case):
    gj, gt, mj, mt = _compile_both(case)
    assert [n.name for n in gj] == [n.name for n in gt]
    for nj in gj.compute_nodes():
        nt = gt[nj.name]
        assert nj.params.get("relu") == nt.params.get("relu")
        _assert_same_value(nj.quant, nt.quant, f"{case}:{nj.name}.quant")
        assert {k: nj.tile[k] for k in "MKN"} == {k: nt.tile[k] for k in "MKN"}
        _assert_same_value(nj.cascade, nt.cascade, f"{case}:{nj.name}.cascade")
        _assert_same_value(nj.packed, nt.packed, f"{case}:{nj.name}.packed")
        _assert_same_value(nj.place, nt.place, f"{case}:{nj.name}.place")
    for nj in gj.inputs() + gj.outputs():
        _assert_same_value(nj.quant, gt[nj.name].quant, nj.name)
        assert dataclasses.asdict(nj.out_spec) == \
            dataclasses.asdict(gt[nj.name].out_spec)
    assert [dataclasses.asdict(e) for e in gj.memtile_edges] == \
        [dataclasses.asdict(e) for e in gt.memtile_edges]
    for key in ("tiles_used", "memtile_bytes", "placement_cost",
                "placement_expanded"):
        assert gj.meta[key] == gt.meta[key], key
    assert mj.tiles_used == mt.tiles_used
    assert mj.memtile_bytes == mt.memtile_bytes
    assert mj.placement_cost == mt.placement_cost
    assert mj.placements() == mt.placements()
    assert (mj.in_shift, mj.in_dtype, mj.out_shift) == \
        (mt.in_shift, mt.in_dtype, mt.out_shift)
    for batch in (1, 16, 128):
        assert mj.estimated_cycles(batch) == mt.estimated_cycles(batch)


@pytest.mark.parametrize("case", ["mlp", "mixed_precision", "int16_weights",
                                  "user_overrides", "half_even_in_shift"])
def test_emitted_models_predict_equal(case):
    """Same graph through each package's passes and emission: the port's
    ``"aie"`` and ``"x86"`` on the CPU == the reference's ``"x86"``."""
    _, _, mj, mt = _compile_both(case)
    x = np.random.default_rng(4).uniform(-1, 1, (16, 48)).astype(np.float32)
    want = mj.predict(x, "x86")
    for mode in ("aie", "x86"):
        got = mt.predict(x, mode)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    raw = mt.predict(x, "aie", dequantize_output=False)
    np.testing.assert_array_equal(
        raw.numpy(), mj.predict(x, "x86", dequantize_output=False))


def test_device_model_equal():
    assert {k: dataclasses.asdict(v) for k, v in J_TILINGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in T_TILINGS.items()}
    dj, dt = jcore.AIEMLDevice(), tcore.AIEMLDevice()
    for pair in J_TILINGS:
        assert dj.peak_gops(*pair) == dt.peak_gops(*pair)
        for shape in ((1, 512, 512), (128, 196, 256), (33, 70, 50)):
            assert dj.kernel_cycles(*shape, *pair, True, True) == \
                dt.kernel_cycles(*shape, *pair, True, True)


@pytest.mark.parametrize("f_in,f_out", [(1, 4096), (8, 2048), (512, 512),
                                        (196, 256), (4096, 8), (2048, 4096)])
def test_resolve_cascade_raises_where_reference_raises(f_in, f_out):
    """The reference's known fault (small f_in, wide f_out at batch 128) is
    copied as is: both raise the same error on the same inputs."""
    t = J_TILINGS[("int8", "int8")]
    kw = dict(batch=128, a_bytes=1, w_bytes=1)
    try:
        want = j_resolve(f_in, f_out, t, jcore.AIEMLDevice(), **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_resolve(f_in, f_out, T_TILINGS[("int8", "int8")],
                      tcore.AIEMLDevice(), **kw)
        assert str(got.value) == str(e)
        return
    got = t_resolve(f_in, f_out, T_TILINGS[("int8", "int8")],
                    tcore.AIEMLDevice(), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_resolve_cascade_fault_case_raises():
    t = T_TILINGS[("int8", "int8")]
    with pytest.raises(ValueError, match="cannot fit tile memory"):
        t_resolve(1, 4096, t, tcore.AIEMLDevice(), batch=128, a_bytes=1,
                  w_bytes=1)


def test_placer_matches_reference():
    blocks = [(2, 3), (1, 4), (3, 1), (2, 2)]
    pj = jcore.Placer(8, 5, beam=None)
    pt = tcore.Placer(8, 5, beam=None)
    rj = pj.branch_and_bound([jcore.Block(w, h) for w, h in blocks])
    rt = pt.branch_and_bound([tcore.Block(w, h) for w, h in blocks])
    assert rj.as_tuples() == rt.as_tuples() and rj.cost == rt.cost
    small = [(2, 2), (1, 3), (2, 1)]
    bj = jcore.Placer(5, 4).brute_force([jcore.Block(w, h) for w, h in small])
    bt = tcore.Placer(5, 4).brute_force([tcore.Block(w, h) for w, h in small])
    assert bj.cost == bt.cost
    for name in ("greedy_right", "greedy_up"):
        gj = getattr(pj, name)([jcore.Block(w, h) for w, h in blocks])
        gt = getattr(pt, name)([tcore.Block(w, h) for w, h in blocks])
        assert gj.as_tuples() == gt.as_tuples() and gj.cost == gt.cost


def test_oversized_model_raises_in_both():
    """A cascade of 20 x 20 tiles exceeds the 304-tile array in both."""
    messages = []
    for core in (jcore, tcore):
        g = _mlp(core)
        g["dense_0"].overrides.update({"cas_len": 20, "cas_num": 20})
        with pytest.raises(ValueError, match="tiles") as err:
            core.run_passes(g, core.CompileConfig())
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_default_device_is_the_card(monkeypatch):
    """Without a card, the entry points raise instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.compile_graph(_mlp(tcore), tcore.CompileConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.compile_graph(_mlp(tcore), tcore.CompileConfig(), device="cuda")
    g = _mlp(tcore)
    tcore.run_passes(g, tcore.CompileConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.EmittedModel(g)
    assert tcore.EmittedModel(g, device="cpu").device == torch.device("cpu")
