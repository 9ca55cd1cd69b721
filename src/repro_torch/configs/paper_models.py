"""The paper's own evaluation workloads (Table III / V) as selectable
configs for the AIE4ML compiler pipeline.

    from repro_torch.configs.paper_models import build_paper_model
    model = build_paper_model("mlp_7layer")   # -> EmittedModel on the card
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import CompileConfig, DenseSpec, build_mlp_graph, compile_graph
from repro_torch.core.emit import DeviceLike, resolve_device

# name: (batch_rows, f_in, widths, description)
PAPER_MODELS: Dict[str, Tuple[int, int, tuple, str]] = {
    "token_mlp_s16": (512, 196, (256, 196),
                      "MLP-Mixer S/16 token mixing: [B*C,T]=[512,196]"),
    "channel_mlp_s16": (196, 512, (2048, 512),
                        "MLP-Mixer S/16 channel mixing: [B*T,C]=[196,512]"),
    "token_mlp_l16": (1024, 196, (512, 196),
                      "MLP-Mixer L/16 token mixing: [B*C,T]=[1024,196]"),
    "mlp_2layer": (256, 1024, (1024, 1024), "2-layer MLP, hidden 1024"),
    "mlp_7layer": (1, 512, (512,) * 7,
                   "7-layer MLP, hidden 512 (Table V cross-device workload)"),
}


def build_paper_graph(name: str, batch: Optional[int] = None, seed: int = 1):
    rows, f_in, widths, _ = PAPER_MODELS[name]
    rng = np.random.default_rng(seed)
    layers = [
        DenseSpec(w, activation="relu", bias=rng.standard_normal(w) * 0.05)
        for w in widths
    ]
    return build_mlp_graph(batch=batch or min(rows, 128), f_in=f_in,
                           layers=layers, seed=seed)


def build_paper_model(name: str, batch: Optional[int] = None,
                      config: Optional[CompileConfig] = None, seed: int = 1,
                      device: DeviceLike = None):
    """Compile one of the paper's workloads through the full pipeline onto
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    g = build_paper_graph(name, batch, seed)
    # paper-scale parallelization where the array allows it
    cfg = config or CompileConfig()
    try:
        g64 = build_paper_graph(name, batch, seed)
        for node in g64.compute_nodes():
            node.overrides.update({"f_in_slice": 64, "f_out_slice": 64})
        return compile_graph(g64, cfg, dev)
    except ValueError:
        return compile_graph(g, cfg, dev)
