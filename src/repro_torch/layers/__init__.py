"""Plain functions on tensors: the layers of the decoder LMs (dense and
MoE), the hybrid and RWKV."""
