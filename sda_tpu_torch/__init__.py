"""sda-tpu-torch: the secure-aggregation round in PyTorch, with CUDA kernels
for NVIDIA Hopper.

A port of the JAX package ``sda_tpu`` (which stays the reference): each
module mirrors its counterpart's layout and names. Residues are held in
int64 tensors throughout (torch has almost no uint32 arithmetic); no global
dtype flag is set. Public entry points take ``device=None``, meaning
``torch.device("cuda")``, and raise ``RuntimeError`` without CUDA unless the
caller passes ``device="cpu"``.

- ``sda_tpu_torch.protocol`` — resources, scheme parameters, service seam
- ``sda_tpu_torch.fields``   — Z_p math: int64 modular and Solinas lanes,
  sharing, dimension tiling, host ChaCha, and the fused
  mask-share-combine kernel
- ``sda_tpu_torch.crypto``   — sharing/masking (on the role's device),
  encryption and signing (the port's own sealed boxes and Ed25519, on
  the host: ``crypto/csrc/sodium.c``)
- ``sda_tpu_torch.client``   — participant/clerk/recipient workflows
- ``sda_tpu_torch.server``   — server core and its stores (memory, jsonfs,
  sqlite, mongo)
- ``sda_tpu_torch.http``     — the REST transport, both directions
- ``sda_tpu_torch.store``    — client-side key/identity storage
- ``sda_tpu_torch.mesh``     — the single-device aggregation round
- ``sda_tpu_torch.models``   — fixed-point codec, model families, local
  training and FedAvg over the protocol or the pods
- ``sda_tpu_torch.fl``       — the FL scenario driver and its data shim
- ``sda_tpu_torch.tree``     — hierarchical rounds and their simulator
- ``sda_tpu_torch.convert``  — schemes, resources, matrices and model
  weights carried across from the JAX package
"""

__version__ = "0.1.0"
