"""sda-tpu-torch: the secure-aggregation round in PyTorch, with CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``sda_tpu`` (which stays the reference): each
module mirrors its counterpart's layout and names. Residues are held in
int64 tensors throughout (torch has almost no uint32 arithmetic); no global
dtype flag is set. Public entry points take ``device=None``, meaning
``torch.device("cuda")``, and raise ``RuntimeError`` without CUDA unless the
caller passes ``device="cpu"``.

- ``sda_tpu_torch.protocol`` — scheme parameters (masking and sharing)
- ``sda_tpu_torch.fields``   — Z_p math: int64 modular and Solinas lanes,
  sharing, dimension tiling, and the fused mask-share-combine kernel
- ``sda_tpu_torch.mesh``     — the single-device aggregation round
- ``sda_tpu_torch.convert``  — schemes and matrices carried across from
  the JAX package
"""

__version__ = "0.1.0"
