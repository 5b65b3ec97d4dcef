"""The math core: Z_m/Z_p kernels, scheme matrices, the fused round kernel."""

from . import chacha, numtheory, oracle
from .modular import (
    canon,
    modadd,
    modmatmul,
    modsub,
    modsum,
    np_modmatmul,
    np_modsum,
    uniform_mod,
)
from .reveal import reconstruct
from .sharing import (
    additive_share,
    additive_share_from_randomness,
    batch_columns,
    combine,
    packed_reconstruct,
    packed_share,
    packed_share_from_randomness,
    unbatch_columns,
)
