"""K3's mask op's share of its roofline: the least time the card could
take for the ChaCha mask stage of the window's rounds (``bounds.k3_bound``
of the ``mask`` op at each tile's shape: keys derived, int32 rows out,
added into the tile's mask accumulator) over the device time of
``chacha_mask_kernel`` and its chunk fold ``chacha_fold_kernel`` in those
rounds."""

from aggbench import bounds


def read(view):
    if view.cell["traffic"]["masking"] != "chacha":
        return None
    bound_ms = sum(bounds.k3_bound(p, w, "mask", 4, derived=True,
                                   accumulate=True)[0]
                   for p, w in view.cell["tiles"])
    us, rounds = view.kernel_us(("chacha_mask_kernel", "chacha_fold_kernel"))
    if not rounds:
        return None
    return 100.0 * bound_ms * 1e3 * rounds / us
