"""Known-bad fixture for RA501 (layering), torch-flavoured. Never
imported.

A launcher doing the plan's job: banned low-level imports (one
laundered through the `wrappers` shim to prove re-export resolution), a
mesh built by hand, and a step compiled and captured outside the plan.
"""

import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.steps import make_serve_step      # RA501: builder
from repro_torch.dist.sharding import specs_to_placements  # RA501: wiring
from wrappers import mode_rules                           # RA501: laundered

from repro_torch.models import SHAPES


def main(cfg, specs):
    mesh = init_device_mesh("cuda", (1, 1))               # RA501: mesh
    rules = mode_rules("cascade")
    placements = specs_to_placements(specs, mesh, rules)
    step = torch.compile(make_serve_step(cfg, SHAPES["decode"]))  # RA501
    graph = torch.cuda.CUDAGraph()                        # RA501: capture
    return step, graph, placements
