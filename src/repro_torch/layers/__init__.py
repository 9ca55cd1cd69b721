"""Plain functions on tensors: the layers of the dense decoder LM."""
