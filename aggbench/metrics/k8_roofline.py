"""K8's share of its roofline: the least time the card could take for the
residue pass of the window's rounds (``bounds.residues_bound`` over each
tile's int64 block) over the device time of ``residues_kernel`` in those
rounds. K8 runs on the K1 lane without ChaCha masks (with them, K3's mask
op takes the residues)."""

from aggbench import bounds


def read(view):
    if view.cell["traffic"]["masking"] == "chacha":
        return None
    bound_ms = sum(bounds.residues_bound(p * w, 8)[0]
                   for p, w in view.cell["tiles"])
    us, rounds = view.kernel_us(("residues_kernel",))
    if not rounds:
        return None
    return 100.0 * bound_ms * 1e3 * rounds / us
