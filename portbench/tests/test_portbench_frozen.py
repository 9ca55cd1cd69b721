"""The frozen copies give what their originals give, at a few shapes, and
their outputs are pinned."""

import pytest
import torch

from portbench.frozen import flops, peaks, work
from portbench.harness import cells


def test_peaks_equal_the_program_s():
    from repro_torch.core.device import H100Target

    t = H100Target()
    for dtype, rate in peaks.PEAK.items():
        assert t.peak(dtype) == rate
    assert t.hbm_bw == peaks.HBM_BYTES_PER_S


@pytest.mark.parametrize("shape", [(2, 32, 2048, 128, True),
                                   (1, 20, 32768, 128, True),
                                   (3, 8, 512, 64, False)])
def test_flash_work(shape):
    from repro_torch.kernels.flash_attention.ops import work as original

    B, H, S, hd, causal = shape
    w = work.flash_work(B, H, H, S, S, hd, "bf16", causal)
    o = original(B * H, S, S, hd, torch.bfloat16, causal)
    assert (w.ops, w.bytes, w.dtype) == (o.ops, o.bytes, o.dtype)
    gqa = work.flash_work(B, H, H // 8 or 1, S, S, hd, "bf16", causal)
    assert gqa.ops == w.ops and gqa.bytes < w.bytes


@pytest.mark.parametrize("variant", [{}, {"qkv_bias": True}])
def test_active_params_equal_the_program_s(variant):
    from repro_torch.launch.model_flops import param_counts

    from portbench.harness.program import arch_config

    cfg = dict(cells.config("yi-6b"), **variant)
    assert flops.active_params(cfg) == param_counts(arch_config(cfg))[1]


def test_model_flops_pinned():
    yi = cells.config("yi-6b")
    assert flops.active_params(yi) == 5_798_891_520
    assert flops.prefill_flops(yi, 4, 2048) == pytest.approx(
        2 * 5_798_891_520 * 8192 + 4 * 32 * 32 * 128 * 4 * 2048 * 2049 / 2)
