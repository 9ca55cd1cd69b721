"""The serving streams of ``tests/test_torch_moe.py``'s MoE models: the
reduced phi3.5-moe and kimi-k2 through the port and the reference in each
mode (fifo, continuous k 1/4, paged k 1/4, speculative k 4 dense and
paged; float and quantized), held to the reference's own streams up to
the first step whose reference gap is below 0.1
(``test_torch_moe.check_streams``). A file of its own, so that ``--dist
loadfile`` runs it beside the layer and model checks."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import pytest
from test_torch_moe import _MODES, ARCHS, check_streams


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_reference(arch, quantized, mode, test_seed):
    check_streams(arch, quantized, mode, test_seed)
