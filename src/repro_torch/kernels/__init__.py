"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions,
their oracles (``ref``) and entry points (``ops``)."""
