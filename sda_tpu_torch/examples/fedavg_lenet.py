"""Secure federated averaging of a real LeNet, end to end.

Four clients train locally on synthetic MNIST-shaped data; only
fixed-point-encoded model deltas are aggregated — masked, secret-shared
across an 8-clerk committee on a device mesh, and revealed as an exact
sum. No individual update ever leaves a client in the clear.

    python -m sda_tpu_torch.examples.fedavg_lenet [--device cpu]

Port of ``examples/fedavg_lenet.py``. The model, its training and the
mesh all live on ``--device``: the mesh is ``make_mesh(4, 2, devices=
[device] * 8)``, the counterpart of the script's 8 virtual host devices.
The weights start from ``LeNet``'s own init (a CPU ``torch.Generator``
seeded 0), not from flax's ``PRNGKey(0)``, so the printed losses differ
from the script's; ``run(params=...)`` starts from given weights (the
script's, through ``convert.family_params_from_flax``), and then the
losses agree to float rounding. The round seeds are the ints 1..3 (the
script's ``PRNGKey(r)``); they draw the shares, not the exact sum.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

M31 = (1 << 31) - 1
N_CLIENTS, ROUNDS, LOCAL_STEPS, SAMPLES = 4, 3, 2, 16
LR, FRACTIONAL_BITS, CLIP, CLERKS = 0.05, 16, 4.0, 8


def run(device=None, params=None, log=None) -> dict:
    """Three secure FedAvg rounds. ``params`` (a ``state_dict`` of
    ``LeNet``) replaces the model's init; ``log`` gets the script's lines.
    Returns ``param_count``, ``losses`` (rounds 0..3), ``globals`` (the
    global vector before each round and after the last, numpy float64),
    ``cohorts`` (each round's [4, d] client vectors, numpy), ``params``
    (the last global's tensors) and ``params_device``."""
    import torch
    import torch.nn.functional as F

    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.mesh import SimulatedPod, make_mesh
    from sda_tpu_torch.models import (FixedPointCodec, LeNet, LocalTrainer,
                                      param_count, pod_fedavg_round,
                                      ravel_pytree, sgd)
    from sda_tpu_torch.protocol import AdditiveSharing

    dev = resolve_device(device)
    log = log or (lambda *a: None)
    model = LeNet(device=dev, generator=torch.Generator().manual_seed(0))
    if params is None:
        params = model.state_dict()
    params = {k: torch.as_tensor(v).detach().to(dev, torch.float32).clone()
              for k, v in params.items()}
    count = param_count(params)
    log(f"LeNet: {count} parameters")
    gvec, unravel = ravel_pytree(params)
    gvec = gvec.cpu().numpy()

    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.normal(size=(N_CLIENTS, SAMPLES, 28, 28, 1))
                         .astype(np.float32), device=dev)
    ys = torch.as_tensor(rng.integers(0, 10, size=(N_CLIENTS, SAMPLES)),
                         device=dev)

    def loss_fn(p, batch):
        x, y = batch
        logits = torch.func.functional_call(model, p, (x,))
        return F.cross_entropy(logits, y)

    trainer = LocalTrainer(loss_fn, sgd(LR), device=dev)
    pod = SimulatedPod(AdditiveSharing(share_count=CLERKS, modulus=M31),
                       mesh=make_mesh(4, 2, devices=[dev] * 8))
    codec = FixedPointCodec(M31, fractional_bits=FRACTIONAL_BITS,
                            max_summands=N_CLIENTS, clip=CLIP)

    def global_loss(p):
        with torch.no_grad():
            return float(np.mean([float(loss_fn(p, (xs[i], ys[i])))
                                  for i in range(N_CLIENTS)]))

    losses, globals_, cohorts = [global_loss(params)], [gvec], []
    log(f"round 0: loss {losses[0]:.4f}")
    for r in range(1, ROUNDS + 1):
        client_vecs = []
        for i in range(N_CLIENTS):
            p = unravel(gvec)
            st = trainer.init_state(p)
            batches = (xs[i].expand(LOCAL_STEPS, *xs[i].shape),
                       ys[i].expand(LOCAL_STEPS, *ys[i].shape))
            p, st, _ = trainer.fit(p, st, batches)
            client_vecs.append(ravel_pytree(p)[0])
        cohorts.append(torch.stack(client_vecs).cpu().numpy())
        gvec = pod_fedavg_round(pod, codec, gvec, client_vecs, seed=r)
        params = unravel(gvec)
        globals_.append(gvec)
        losses.append(global_loss(params))
        log(f"round {r}: loss {losses[-1]:.4f} "
            f"(secure mesh round over {N_CLIENTS} encoded deltas)")
    return {"param_count": count, "losses": losses, "globals": globals_,
            "cohorts": cohorts, "params": params,
            "params_device": str(next(iter(params.values())).device)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="device of the model, its training and the "
                             "mesh (default cuda; cpu for the host)")
    args = parser.parse_args(argv)
    rec = run(args.device, log=print)
    assert np.all(np.isfinite(rec["losses"])), rec["losses"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
