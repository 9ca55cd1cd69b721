"""Shim that launders a plan-internal symbol: importing `mode_rules`
from here is still importing `rules_for_mode` from the banned
`repro_torch.dist.sharding`; RA501 resolves the re-export chain."""

from repro_torch.dist.sharding import rules_for_mode as mode_rules

__all__ = ["mode_rules"]
