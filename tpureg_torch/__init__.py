"""tpureg_torch — the PyTorch / CUDA port of tpureg for the NVIDIA H100.

The JAX package ``tpureg`` stays the reference; this package re-implements
it one slice at a time and is tested against it. Slice 1 is the FlowNet2
registration-inference path:

- ``ops``: correlation (CUDA kernel K1, ``csrc/correlation.cu``), bilinear
  warp (CUDA kernel K3, ``csrc/warp2d.cu``), channel norm and resize; each
  kernel beside its plain PyTorch version;
- ``nn``, ``models``: the FlowNet2 cascade (FlowNetC, FlowNetS, FlowNetSD,
  FlowNetFusion) with the reference's torch key names, NCHW inside;
- ``reg``: the registration head; ``losses``: the multi-scale OFE loss;
- ``train``: the evaluation step and best-weight files; ``compat``: the
  weight bridge from tpureg's flax trees;
- ``data``, ``metrics``, ``cli``: Analyze data, the numpy metric suite and
  the inference CLI.

Nothing here imports JAX or tpureg. Entry points run on the card unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
