"""The port's data pipeline: the reference's synthetic token stream."""

from repro_torch.data.pipeline import SyntheticTokens, make_train_iterator

__all__ = ["SyntheticTokens", "make_train_iterator"]
