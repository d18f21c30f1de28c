"""tpureg_torch — the PyTorch / CUDA port of tpureg for the NVIDIA H100.

The JAX package ``tpureg`` stays the reference; this package re-implements
it one slice at a time and is tested against it. Slice 1 is the FlowNet2
registration-inference path, slice 2 FlowNet2 training, slice 3 the 3-D
volumetric training path (VoxelMorph3D and AffineNet3D):

- ``ops``: correlation (CUDA kernels K1 and K2, ``csrc/correlation*.cu``),
  bilinear warp (K3, K4, K5, ``csrc/warp2d*.cu``), trilinear 3-D warp (K6a,
  K6b, K6c, ``csrc/warp3d.cu``), channel norm, resize and the elastic field;
  each kernel one ``torch.library`` op ``tpureg::*`` (``ops/library.py``)
  beside its plain PyTorch version;
- ``nn``, ``models``: the FlowNet2 cascade (FlowNetC, FlowNetS, FlowNetSD,
  FlowNetFusion) with the reference's torch key names, and the 3-D models
  with flax's module names; NCHW and NCDHW inside;
- ``reg``: the registration head; ``losses``: the multi-scale OFE loss and
  the volumetric losses; ``classical``: scaling-and-squaring integration;
- ``train``: the eval and train steps, Adam, the schedule and checkpoints;
  ``compat``: the weight bridge from tpureg's flax trees, the torch
  checkpoint import, the Caffe reader and layer-ordered import;
- ``parallel``: data-parallel training across processes with tpureg's
  global-batch semantics, and tpureg's FSDP layout of a train state;
- ``serving``: the head's eval forward exported with ``torch.export``;
- ``data``, ``metrics``, ``cli``: Analyze data and the volume and slice
  pipelines, the numpy metric suite, the inference, training, comparator
  and export CLIs.

Nothing here imports JAX or tpureg. Entry points run on the card unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
