"""Wire-format numerics: codebooks, two-level scaling, block quantization,
packing and the ``QTensor`` container."""
