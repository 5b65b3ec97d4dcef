"""K1's share of its roofline: the least time the card could take for the
share + combine work of the window's rounds (``bounds.k1_bound`` at each
tile's shape, the Philox draws that the tile's masking needs, the
accumulators read and written) over the device time of K1's kernels
(``fused_round_*``) in those rounds."""

from aggbench import bounds


def read(view):
    sc = view.cell["config"]["scheme"]
    masking = view.cell["traffic"]["masking"]
    k, n, t = sc["secret_count"], sc["share_count"], sc["privacy_threshold"]
    # Full masks are drawn and summed in K1; ChaCha masks come from K3
    masked = masking == "full"
    draws = t + (k if masked else 0)
    rows = n + (k if masked else 0)
    muls, xors = bounds.philox_ops(k, t, masked)
    bound_ms = sum(bounds.k1_bound(p, w // k, k, draws, True, rows, muls,
                                   xors, acc_rows=rows)[0]
                   for p, w in view.cell["tiles"])
    us, rounds = view.kernel_us(("fused_round_",))
    if not rounds:
        return None
    return 100.0 * bound_ms * 1e3 * rounds / us
