"""Flagship FL model families and their aggregate-vector dimensions.

Port of ``sda_tpu/fl/flagship.py``. The model-scale device plane
(``loadgen/devscale.py``) benches the round at the dimensions real FL
workloads ship — the benchmark families from ``models/families.py``,
sized here WITHOUT materializing any parameter (the family is built on
``torch.device("meta")``, where a parameter is a shape and no storage):
``mobilelite`` is the full 3,731,890-param update vector, ``lora`` is
the 11,782,400-element trainable adapter sub-tree (the base is frozen
and never aggregated). ``devscale`` at ``dim=1e8`` is the headroom rung
above both — a transformer-adapter-scale vector the ROADMAP names as the
model-scale target.

``flagship_dim`` is deterministic and cheap, so profiles can resolve a
family name to its exact dimension at CLI time; tests pin the dims
against the families' documented sizes.
"""

from __future__ import annotations

__all__ = ["FLAGSHIP_FAMILIES", "flagship_dim", "flagship_dims"]

#: family name -> builder returning the aggregated-vector dimension
FLAGSHIP_FAMILIES = ("mobilelite", "lora")

#: the ROADMAP model-scale rung: dim >= 1e8, above every shipped family
DEVSCALE_DIM = 100_000_000


def flagship_dim(family: str) -> int:
    """The aggregated-vector dimension of a flagship family.

    ``mobilelite`` — every trainable parameter of the MobileLite
    default config (32x32x3 inputs); ``lora`` — the trainable LoRA
    adapter sub-tree of the default LoRAMLP (28x28 inputs); ``devscale``
    — the fixed 1e8 model-scale rung.
    """
    from ..models import families

    if family == "devscale":
        return DEVSCALE_DIM
    if family == "mobilelite":
        return families.param_count(families.MobileLite(device="meta"))
    if family == "lora":
        return families.param_count(families.lora_adapter_params(
            families.LoRAMLP(in_features=28 * 28, device="meta")))
    raise ValueError(
        f"unknown flagship family {family!r} "
        f"(one of {FLAGSHIP_FAMILIES + ('devscale',)})")


def flagship_dims() -> dict:
    """{family: dim} for every flagship family plus the devscale rung —
    the table docs/performance.md renders."""
    out = {name: flagship_dim(name) for name in FLAGSHIP_FAMILIES}
    out["devscale"] = DEVSCALE_DIM
    return out
