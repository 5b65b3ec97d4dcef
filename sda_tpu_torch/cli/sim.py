"""`sda-sim` of the PyTorch port — run secure-aggregation rounds in
simulated-pod mode: counterpart of ``sda_tpu/cli/sim.py``.

The clerk committee lives on a ``('p', 'd')`` mesh of devices
(mesh/simpod.py), or the round streams through chunked single-device
rounds for workloads larger than device memory (mesh/streaming.py).
``--device`` (``cuda``, or ``cpu`` for the host) places the round: the
default asks for CUDA and raises without it. ``--pallas`` runs each
shard's mask + share + combine on the fused kernel (K1, CUDA only), and
``--mask chacha`` expands the ChaCha seed masks on K3. Prints one JSON
line with timing and the verification verdict.

    python -m sda_tpu_torch.cli.sim --participants 100 --dim 9999 --clerks 8
    python -m sda_tpu_torch.cli.sim --participants 1000 --dim 3000000 \\
        --streaming --pallas --mask chacha
    python -m sda_tpu_torch.cli.sim --device cpu --participants 8 --dim 24

Six drill profiles exercise the serving plane instead of the kernels:
``--chaos`` (fault injection, chaos/drill.py), ``--load`` (capacity
measurement + admission control, loadgen/driver.py), ``--tree``
(hierarchical population-scale rounds, sda_tpu_torch/tree), ``--soak``
(continuous multi-tenant service, sda_tpu_torch/service),
``--analytics`` (secure histograms / heavy hitters / quantiles / A/B
metrics as multi-tenant recurring rounds, sda_tpu_torch/analytics) and
``--fl`` (secure FedAvg end-to-end over the full substrate,
sda_tpu_torch/fl, training on ``--device``). Their clients run their
field arithmetic on ``--device`` too. ``--devscale`` is the model-scale
device-plane bench (loadgen/devscale.py):

    python -m sda_tpu_torch.cli.sim --load --participants 200 --load-rps 150
    python -m sda_tpu_torch.cli.sim --tree --participants 24 --tree-dropout 0.1
    python -m sda_tpu_torch.cli.sim --analytics histogram,countmin \\
        --analytics-epochs 3
    python -m sda_tpu_torch.cli.sim --fl --participants 8 --fl-family lenet
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sda-sim", description="simulated-pod secure aggregation"
    )
    parser.add_argument("--participants", type=int, default=64)
    parser.add_argument("--dim", type=int, default=9999)
    parser.add_argument("--clerks", type=int, default=8,
                        help="committee size (packed sharing needs "
                             "3^a - 1: 2, 8, 26, ...; basic takes any)")
    parser.add_argument("--sharing", choices=["packed", "basic"],
                        default="packed",
                        help="packed (NTT Shamir, k secrets/poly) or basic "
                             "(classic t+1-of-n Shamir, any committee size)")
    parser.add_argument("--secrets-per-batch", type=int, default=None,
                        help="packed sharing only (default 3)")
    parser.add_argument("--modulus-bits", type=int, default=28)
    parser.add_argument("--mask", choices=["none", "full", "chacha"],
                        default="full")
    parser.add_argument("--checkpoint", metavar="PATH",
                        help="streamed modes: snapshot/resume path "
                             "(single-process file, or coordinated "
                             "per-rank snapshots under --multihost)")
    parser.add_argument("--streaming", action="store_true",
                        help="chunked single-device rounds (sizes beyond "
                             "device memory)")
    parser.add_argument("--participants-chunk", type=int, default=64)
    parser.add_argument("--pallas", action="store_true",
                        help="fused local step on the K1 kernel "
                             "(packed-Shamir x Solinas x none/full/chacha "
                             "masking; CUDA)")
    parser.add_argument("--load", action="store_true",
                        help="capacity profile: drive N simulated "
                             "participants through a full round over real "
                             "HTTP (open-loop Poisson or closed-loop) and "
                             "print the capacity report (sustained RPS, "
                             "p50/p95/p99 per route, shed/retry rates)")
    parser.add_argument("--load-arrivals", choices=["open", "closed"],
                        default="open",
                        help="workload model: open-loop seeded Poisson "
                             "arrivals at --load-rps, or closed-loop "
                             "request-after-request (--load)")
    parser.add_argument("--load-rps", type=float, default=100.0,
                        help="open-loop participant arrival rate (--load)")
    parser.add_argument("--load-concurrency", type=int, default=32,
                        help="worker threads driving participants (--load)")
    parser.add_argument("--load-seed", type=int, default=0,
                        help="arrival schedule + input seed (--load)")
    parser.add_argument("--load-store", choices=["memory", "sqlite", "jsonfs"],
                        default="memory",
                        help="server store backend for --load")
    parser.add_argument("--load-overload", action="store_true",
                        help="forced overload profile: arm a tight "
                             "per-agent token bucket so the server sheds "
                             "with 429+Retry-After and clients must "
                             "converge via retry (--load)")
    parser.add_argument("--load-rate", type=float, default=None,
                        help="per-agent admission rate, tokens/sec "
                             "(--load; --load-overload presets 8)")
    parser.add_argument("--load-burst", type=float, default=None,
                        help="per-agent admission burst (--load; "
                             "--load-overload presets 2)")
    parser.add_argument("--load-max-inflight", type=int, default=None,
                        help="bounded in-flight admission cap (--load)")
    parser.add_argument("--load-chaos-rate", type=float, default=0.0,
                        help="combined load+chaos drill: also 500 this "
                             "fraction of requests (--load)")
    parser.add_argument("--load-churn", type=float, metavar="RATE",
                        default=0.0,
                        help="device churn under load: this seeded "
                             "fraction of participants crashes mid-"
                             "participation (journal written, upload "
                             "possibly in the lost-ack window) and "
                             "rejoins via journal resume; the capacity "
                             "report carries the resume/replay counters "
                             "(--load; docs/load.md)")
    parser.add_argument("--load-codec", choices=["auto", "json", "bin"],
                        default="auto",
                        help="wire codec for the swarm: auto (negotiate "
                             "application/x-sda-bin via the server advert), "
                             "json (legacy wire pinned), bin (forced "
                             "binary) (--load)")
    parser.add_argument("--load-fleet", type=int, metavar="N", default=0,
                        help="fleet scaling drill: run the SAME fixed-seed "
                             "load against 1 and then N real `sdad` worker "
                             "processes over one shared store "
                             "(--load-store sqlite/jsonfs) and report one "
                             "BENCH-style scaling record (fleet_nodes, "
                             "scaling_efficiency) (--load; "
                             "docs/scaling.md)")
    parser.add_argument("--load-fleet-baseline", type=int, metavar="N",
                        default=1,
                        help="baseline worker count for the scaling "
                             "record's speedup denominator (--load-fleet)")
    parser.add_argument("--tree", action="store_true",
                        help="hierarchical-aggregation profile: plan a "
                             "multi-level tree (sda_tpu_torch/tree), run it "
                             "through the real HTTP stack — leaf rounds, "
                             "relays re-sharing masked totals, root "
                             "reveal — assert bit-exactness vs a flat "
                             "reference round, and emit the simulated "
                             "population-scale BENCH record "
                             "(docs/scaling.md)")
    parser.add_argument("--tree-group-size", type=int, default=5,
                        help="participants per leaf group (--tree)")
    parser.add_argument("--tree-fanout", type=int, default=None,
                        help="max child relays per internal round; "
                             "default: one parent absorbs every leaf "
                             "(2-level tree) (--tree)")
    parser.add_argument("--tree-store",
                        choices=["memory", "sqlite", "jsonfs"],
                        default="sqlite",
                        help="server store backend for --tree")
    parser.add_argument("--tree-sharing", choices=["additive", "packed"],
                        default="additive",
                        help="committee sharing per level: additive "
                             "(cheap, zero dead-clerk tolerance) or "
                             "packed Shamir (quorum completion) (--tree)")
    parser.add_argument("--tree-mask", choices=["none", "full", "chacha"],
                        default="chacha",
                        help="masking scheme, shared by every level "
                             "(--tree)")
    parser.add_argument("--tree-dropout", type=float, default=0.0,
                        help="seeded chaos dropout rate at the leaves "
                             "(participant.dies kill failpoint) (--tree)")
    parser.add_argument("--tree-dead-clerks", type=int, default=0,
                        help="permanently kill K clerks of the first "
                             "leaf's committee: packed degrades the leaf "
                             "and the root stays exact; additive fails "
                             "the leaf AND the root with a reason "
                             "naming the leaf (--tree)")
    parser.add_argument("--tree-seed", type=int, default=0,
                        help="plan/input/chaos seed (--tree)")
    parser.add_argument("--tree-sim", type=int, metavar="N",
                        default=100_000,
                        help="also run the simulated population-scale "
                             "round at N participants (real planner + "
                             "modular tree algebra, streamed batches, "
                             "bounded per-node memory asserted) and "
                             "attach its BENCH record; 0 disables "
                             "(--tree)")
    parser.add_argument("--soak", action="store_true",
                        help="continuous-service profile: T tenants x R "
                             "pipelined epochs of recurring real-crypto "
                             "rounds (sda_tpu_torch/service) — scheduler-minted "
                             "epochs (epoch R+1 collecting while R "
                             "clerks), retention purging revealed rounds, "
                             "churn + chaos armable — asserting bit-exact "
                             "reveals per epoch, zero cross-epoch/cross-"
                             "tenant leakage and flat store size + RSS; "
                             "prints a BENCH-style record whose headline "
                             "is sustained rounds_per_hour plus a "
                             "per-tenant capacity table (docs/service.md)")
    parser.add_argument("--soak-tenants", type=int, metavar="T", default=4,
                        help="tenants (recipients with recurring "
                             "schedules) (--soak)")
    parser.add_argument("--soak-epochs", type=int, metavar="R", default=5,
                        help="epochs (recurring rounds) per tenant "
                             "(--soak)")
    parser.add_argument("--soak-participants", type=int, metavar="P",
                        default=4,
                        help="devices per tenant, stable across epochs "
                             "(>= 3: the pipelining and replay probes "
                             "reserve two) (--soak)")
    parser.add_argument("--soak-store",
                        choices=["memory", "sqlite", "jsonfs"],
                        default="sqlite",
                        help="store backend for --soak")
    parser.add_argument("--soak-fleet", type=int, metavar="N", default=0,
                        help="drive the soak against N real `sdad` worker "
                             "processes over one shared store "
                             "(--soak-store sqlite/jsonfs) (--soak)")
    parser.add_argument("--soak-chaos-rate", type=float, default=0.0,
                        help="also 500 this fraction of requests (--soak)")
    parser.add_argument("--soak-churn", type=float, metavar="RATE",
                        default=0.0,
                        help="seeded device churn per epoch: departing "
                             "devices journal, crash (possibly in the "
                             "lost-ack window) and rejoin via resume "
                             "(--soak)")
    parser.add_argument("--soak-tenant-rate", type=float, metavar="RPS",
                        default=None,
                        help="arm the per-tenant admission budget at this "
                             "rate (--soak)")
    parser.add_argument("--soak-retain", type=float, metavar="SECONDS",
                        default=0.0,
                        help="revealed-round retention TTL; 0 purges a "
                             "revealed round on the next sweep (--soak)")
    parser.add_argument("--soak-seed", type=int, default=0,
                        help="input/schedule/chaos seed (--soak)")
    parser.add_argument("--analytics", metavar="PROFILE", default=None,
                        help="federated-analytics profile: run each "
                             "requested encoder kind as its own tenant of "
                             "recurring scheduler-minted rounds over the "
                             "real stack (sda_tpu_torch/analytics) — secure "
                             "histograms, count-min/count-sketch heavy "
                             "hitters, quantiles, A/B metrics — asserting "
                             "bit-exact reveals and decoder error within "
                             "each encoder's declared contract; PROFILE "
                             "is a comma list of histogram, countmin, "
                             "countsketch, quantile, ab (aliases: heavy, "
                             "all); prints the BENCH-style values/s "
                             "record (docs/analytics.md)")
    parser.add_argument("--analytics-tenants", type=int, metavar="T",
                        default=None,
                        help="tenants (recurring schedules); kinds cycle "
                             "when T exceeds the profile list; default "
                             "one per requested kind (--analytics)")
    parser.add_argument("--analytics-participants", type=int, metavar="P",
                        default=4,
                        help="devices per tenant (>= 2) (--analytics)")
    parser.add_argument("--analytics-epochs", type=int, metavar="R",
                        default=2,
                        help="recurring rounds per tenant (--analytics)")
    parser.add_argument("--analytics-values", type=int, metavar="V",
                        default=8,
                        help="private values (samples/items) per device "
                             "per epoch (--analytics)")
    parser.add_argument("--analytics-domain", type=int, default=24,
                        help="sketch item universe for heavy-hitter "
                             "queries (--analytics)")
    parser.add_argument("--analytics-bins", type=int, default=32,
                        help="histogram/quantile grid bins (--analytics)")
    parser.add_argument("--analytics-width", type=int, default=64,
                        help="sketch width; eps = e/width (--analytics)")
    parser.add_argument("--analytics-depth", type=int, default=4,
                        help="sketch depth; count-min delta = e^-depth "
                             "(--analytics)")
    parser.add_argument("--analytics-store",
                        choices=["memory", "sqlite", "jsonfs"],
                        default="memory",
                        help="server store backend for --analytics")
    parser.add_argument("--analytics-http", action="store_true",
                        help="drive devices over a real HTTP server "
                             "instead of the in-process seam "
                             "(--analytics)")
    parser.add_argument("--analytics-fleet", type=int, metavar="N",
                        default=0,
                        help="drive the drill against N real sdad worker "
                             "processes over one shared sqlite/jsonfs "
                             "store (--analytics)")
    parser.add_argument("--analytics-modulus-bits", type=int, default=28,
                        help="packed-Shamir sharing prime size "
                             "(--analytics)")
    parser.add_argument("--analytics-seed", type=int, default=0,
                        help="data/hash-family/schedule seed "
                             "(--analytics)")
    parser.add_argument("--fl", action="store_true",
                        help="federated-learning profile: R rounds of "
                             "secure FedAvg over the full substrate "
                             "(sda_tpu_torch/fl) — a seeded device population "
                             "(--participants) with availability churn "
                             "(journal + resume), local training, "
                             "fixed-point encoding, scheduler-minted "
                             "epochs, lifecycle-driven reveal with "
                             "Shamir degradation on dead clerks, "
                             "dropout-weighted global updates and an "
                             "optional central-DP knob; prints the "
                             "BENCH-style accuracy-vs-rounds record "
                             "(docs/federated.md)")
    parser.add_argument("--fl-family",
                        choices=["linear", "lenet", "mobilelite", "lora"],
                        default="linear",
                        help="model family; linear is the fast smoke, "
                             "lenet the 61k-param CI drill (--fl)")
    parser.add_argument("--fl-rounds", type=int, metavar="R", default=3,
                        help="FedAvg rounds = schedule epochs (--fl)")
    parser.add_argument("--fl-local-steps", type=int, default=4,
                        help="optimizer steps per device per round (--fl)")
    parser.add_argument("--fl-batch", type=int, default=16,
                        help="local minibatch size (--fl)")
    parser.add_argument("--fl-shard", type=int, default=64,
                        help="training examples per device (--fl)")
    parser.add_argument("--fl-eval", type=int, default=256,
                        help="held-out evaluation examples (--fl)")
    parser.add_argument("--fl-lr", type=float, default=0.1,
                        help="local SGD learning rate (--fl)")
    parser.add_argument("--fl-target", type=float, metavar="ACC",
                        default=0.8,
                        help="target eval accuracy; the record's headline "
                             "is rounds-to-target (--fl)")
    parser.add_argument("--fl-churn", type=float, metavar="RATE",
                        default=0.0,
                        help="per-round device availability churn: this "
                             "seeded fraction departs mid-round (seal + "
                             "journal, crash pre- or mid-upload) and "
                             "resumes next round; pre-upload departures "
                             "ARE the round's dropout (--fl)")
    parser.add_argument("--fl-dead-clerks", type=int, metavar="K",
                        default=0,
                        help="permanently kill K committee clerks: every "
                             "round must degrade and still reveal "
                             "bit-exactly from the surviving Shamir "
                             "quorum (--fl)")
    parser.add_argument("--fl-dp-sigma", type=float, metavar="S",
                        default=0.0,
                        help="central-DP noise multiplier on the revealed "
                             "sum (0 = off); the report carries the "
                             "composed zCDP/epsilon accounting (--fl)")
    parser.add_argument("--fl-dp-delta", type=float, default=1e-5,
                        help="delta for the epsilon conversion (--fl)")
    parser.add_argument("--fl-store",
                        choices=["memory", "sqlite", "jsonfs"],
                        default="memory",
                        help="server store backend for --fl")
    parser.add_argument("--fl-http", action="store_true",
                        help="drive devices over a real HTTP server "
                             "instead of the in-process seam (--fl)")
    parser.add_argument("--fl-fleet", type=int, metavar="N", default=0,
                        help="drive the scenario against N real sdad "
                             "worker processes over one shared "
                             "sqlite/jsonfs store (--fl)")
    parser.add_argument("--fl-chaos-rate", type=float, default=0.0,
                        help="also 500 this fraction of requests (--fl)")
    parser.add_argument("--fl-tree-group", type=int, metavar="G",
                        default=0,
                        help="population-scale mode: aggregate each round "
                             "through sda_tpu_torch/tree with G devices per "
                             "leaf group (--fl)")
    parser.add_argument("--poison", type=float, metavar="RATE",
                        default=0.0,
                        help="adversarial-input drill: each round a seeded "
                             "plan (chaos/poison.py, churn_schedule's "
                             "(seed, epoch) discipline) marks this "
                             "fraction of devices as attackers — they "
                             "corrupt their model delta per --poison-kind "
                             "AND taint their share upload out-of-field "
                             "(detectable as clerk.share.out_of_range); "
                             "rounds stay bit-exact over what was "
                             "actually submitted (--fl)")
    parser.add_argument("--poison-kind", metavar="KIND",
                        default="boost:-8",
                        help="attack kind: boost:FACTOR (scaled delta, "
                             "negative flips AND amplifies), signflip, or "
                             "backdoor:DIM (trigger-stamped local "
                             "training toward class 0; the report gains "
                             "per-round attack success) (--poison)")
    parser.add_argument("--fl-norm-clip", type=float, metavar="L2",
                        default=None,
                        help="input-side defense: L2 norm bound enforced "
                             "by construction in the fixed-point codec — "
                             "no client-submitted update can carry more "
                             "Euclidean mass than this (--fl)")
    parser.add_argument("--fl-tree-robust", action="store_true",
                        help="robust recipient aggregation in tree mode: "
                             "the root unmasks each leaf subtotal (sealed "
                             "to it anyway) and applies a per-coordinate "
                             "trimmed mean over per-leaf mean deltas "
                             "instead of the population mean "
                             "(--fl --fl-tree-group)")
    parser.add_argument("--fl-mnist", metavar="DIR", default=None,
                        help="load MNIST-format IDX files from DIR "
                             "instead of the seeded synthetic dataset "
                             "(--fl; nothing is downloaded)")
    parser.add_argument("--fl-clip", type=float, default=1.0,
                        help="per-coordinate delta clip (--fl)")
    parser.add_argument("--fl-modulus-bits", type=int, default=28,
                        help="packed-Shamir sharing prime size (--fl)")
    parser.add_argument("--fl-seed", type=int, default=0,
                        help="data/shard/churn/DP seed (--fl)")
    parser.add_argument("--async-http", action="store_true",
                        help="serve the drill profiles (--chaos, --load, "
                             "--fl) on the asyncio event-loop HTTP "
                             "plane instead of thread-per-connection — "
                             "fixed-seed drills must stay bit-exact "
                             "across planes (docs/scaling.md); --pickup "
                             "and --connstorm bench the async plane "
                             "directly (--connstorm-threaded compares)")
    parser.add_argument("--pickup", action="store_true",
                        help="job-pickup A/B bench: the SAME fixed-seed "
                             "multi-snapshot round driven by polling "
                             "clerks and then long-poll clerks "
                             "(GET /v1/clerking-jobs?wait=S); prints the "
                             "BENCH record whose headline is the "
                             "long-poll enqueue->lease p99 (direction: "
                             "lower) with the polling baseline and "
                             "speedup alongside (docs/load.md)")
    parser.add_argument("--pickup-snapshots", type=int, default=6,
                        help="snapshots per mode — samples = snapshots x "
                             "committee size (--pickup)")
    parser.add_argument("--pickup-interval", type=float, default=0.5,
                        help="polling baseline's sleep between empty "
                             "polls, seconds (--pickup)")
    parser.add_argument("--pickup-wait", type=float, default=10.0,
                        help="long-poll park budget per request, seconds "
                             "(--pickup)")
    parser.add_argument("--pickup-seed", type=int, default=0,
                        help="input/stagger seed (--pickup)")
    parser.add_argument("--connstorm", type=int, metavar="N", default=0,
                        help="connection-storm drill: hold N concurrent "
                             "open connections against ONE sdad worker "
                             "subprocess (async plane unless "
                             "--connstorm-threaded), ping in waves, "
                             "assert zero 5xx + bounded RSS + clean "
                             "SIGTERM drain; prints the BENCH record "
                             "(docs/scaling.md)")
    parser.add_argument("--connstorm-waves", type=int, default=2,
                        help="request waves over the held connections "
                             "(--connstorm)")
    parser.add_argument("--connstorm-rss-limit", type=float, default=1024.0,
                        help="worker RSS ceiling in MiB with every "
                             "connection open (--connstorm)")
    parser.add_argument("--connstorm-threaded", action="store_true",
                        help="storm the thread-per-connection plane "
                             "instead (comparison runs) (--connstorm)")
    parser.add_argument("--devscale", action="store_true",
                        help="model-scale device-plane bench: the full "
                             "round at FL-model dimension, sharded over "
                             "the (p, d) mesh, streamed through device "
                             "memory at "
                             "the watermark-derived tile width, with the "
                             "clerk-fed device-tile sink exercised "
                             "(loadgen/devscale.py); one BENCH-style "
                             "JSON line (docs/performance.md)")
    parser.add_argument("--devscale-dim", type=int, metavar="D",
                        default=100_000_000,
                        help="round dimension (--devscale; default the "
                             "1e8 model-scale rung)")
    parser.add_argument("--devscale-family",
                        choices=["mobilelite", "lora", "devscale"],
                        default=None,
                        help="size the dimension from a flagship FL "
                             "family instead of --devscale-dim "
                             "(sda_tpu_torch/fl/flagship.py)")
    parser.add_argument("--devscale-participants", type=int, default=8,
                        help="participant rows (--devscale)")
    parser.add_argument("--devscale-shards", metavar="PxD", default=None,
                        help="mesh shape, e.g. 4x2 (--devscale; default "
                             "from the device count and committee)")
    parser.add_argument("--devscale-tile", type=int, default=None,
                        help="explicit dim-tile width (--devscale; "
                             "default derives from the device-memory "
                             "watermark)")
    parser.add_argument("--devscale-pallas", action="store_true",
                        help="fuse the per-tile mask+share+combine into "
                             "the K1 kernel on the sharded path "
                             "(--devscale; its plain version on the CPU)")
    parser.add_argument("--devscale-rounds", type=int, default=3,
                        help="rounds (1 warm + N-1 timed) (--devscale)")
    parser.add_argument("--devscale-mask",
                        choices=["none", "full", "chacha"], default="full",
                        help="masking scheme (--devscale)")
    parser.add_argument("--devscale-seed", type=int, default=0,
                        help="input/randomness seed (--devscale)")
    parser.add_argument("--chaos", action="store_true",
                        help="robustness profile: run a full federated "
                             "round over real HTTP with deterministic "
                             "fault injection (500s, dropped responses, "
                             "store faults, one abandoned clerking job) "
                             "and print the chaos/retry counter report")
    parser.add_argument("--chaos-rate", type=float, default=0.15,
                        help="fraction of HTTP requests to fail (--chaos)")
    parser.add_argument("--chaos-seed", type=int, default=0,
                        help="failpoint schedule seed (--chaos)")
    parser.add_argument("--chaos-store", choices=["memory", "sqlite", "jsonfs"],
                        default="memory",
                        help="server store backend for --chaos")
    parser.add_argument("--chaos-spec", action="append", default=None,
                        metavar="SPEC",
                        help="extra failpoints, e.g. "
                             "'store.poll_clerking_job=error,times=2' or "
                             "'store.poll_clerking_job,store."
                             "create_clerking_result=brownout:0.02,"
                             "rate=0.7,for=2'. Repeatable — brownout + "
                             "kill drills compose; arming one failpoint "
                             "twice is rejected with a clear error (see "
                             "sda_tpu_torch.chaos.configure_from_specs)")
    parser.add_argument("--brownout", type=float, metavar="SECONDS",
                        default=0.0,
                        help="store-brownout recovery drill (--chaos): "
                             "mid-clerking, the store backend browns out "
                             "for SECONDS (elevated error rate + latency "
                             "on every job poll/result write) behind a "
                             "circuit breaker; the round must still "
                             "reveal bit-exactly and the report records "
                             "the breaker's time_to_recover_s MTTR "
                             "(docs/robustness.md)")
    parser.add_argument("--churn", type=float, metavar="RATE", default=0.0,
                        help="device-churn drill (--chaos): this seeded "
                             "fraction of participants crashes mid-round "
                             "— before the upload or in the lost-ack "
                             "window after the server stored it — then "
                             "rejoins as a fresh process resuming its "
                             "journaled participation; the round must "
                             "reveal bit-exactly with zero double-counted "
                             "participations and the injected "
                             "equivocation probe rejected "
                             "(docs/robustness.md)")
    parser.add_argument("--dead-clerks", type=int, metavar="K", default=0,
                        help="permanently kill K clerks (clerk.dies kill "
                             "failpoint) and arm the round lifecycle "
                             "supervisor: packed Shamir must complete "
                             "degraded + bit-exact from the surviving "
                             "quorum, additive must reach terminal "
                             "'failed' before the deadline (--chaos; "
                             "docs/robustness.md)")
    parser.add_argument("--chaos-sharing", choices=["packed", "additive"],
                        default="packed",
                        help="committee sharing scheme for the chaos "
                             "drill: packed Shamir tolerates dead clerks "
                             "down to its reconstruction threshold, "
                             "additive tolerates none (--chaos)")
    parser.add_argument("--drop-clerks", type=str, metavar="I,J,...",
                        default=None,
                        help="simulate losing these clerk indices: the "
                             "finale reveals from the surviving quorum only")
    parser.add_argument("--trace-out", metavar="PATH", default=None,
                        help="export the run's span timeline as Chrome-trace "
                             "JSON (load in chrome://tracing / Perfetto; "
                             "works with the drill profiles and the mesh "
                             "modes; see docs/observability.md)")
    parser.add_argument("--multihost", type=int, metavar="N", default=0,
                        help="spawn N OS processes (torch.distributed: "
                             "NCCL on cuda, gloo on cpu); each "
                             "owns 1/N of the participants and devices")
    parser.add_argument("--devices-per-process", type=int, default=4,
                        help="mesh entries of its device per multihost "
                             "process")
    parser.add_argument("--device", default="cuda",
                        help="device of the round, the drills' clients and "
                             "the FL training (cuda, or cpu for the host)")
    parser.add_argument("--verify", action="store_true",
                        help="recompute the plain sum on host and compare")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    return parser


def _export_trace(args, report=None) -> None:
    """--trace-out: write the recorded span timeline as Chrome-trace JSON
    (and note the path in the report when one is being assembled)."""
    if not args.trace_out:
        return
    import os

    from .. import obs

    # multihost workers all inherit the same argv: give each rank its own
    # file instead of racing N writers over one path (rank 0 — whose JSON
    # line is the forwarded result — keeps the exact requested path)
    path = args.trace_out
    rank = os.environ.get("SDA_SIM_PID")
    if rank and rank != "0":
        path = f"{path}.rank{rank}"
    trace = obs.export_chrome_trace(path)
    if report is not None:
        report["trace_out"] = path
        report["trace_events"] = len(trace["traceEvents"])


def _devices_per_process(args, n: int) -> int:
    """Mesh entries of each of ``n`` processes' slices. The mesh contract
    (multihost._check_mesh_process_split) needs every entry of a slice
    used: p_per_slice * d_shards entries. With d_shards=1 the per-process
    count must divide the per-process committee span, so
    ``--devices-per-process`` shrinks until it does."""
    devs = args.devices_per_process
    while devs > 1 and args.clerks % (n * devs):
        devs -= 1
    return devs


def _run_multihost(args, argv=None) -> int:
    """Coordinator: validate flags, spawn N workers re-invoking this CLI
    (output to temp files — captured PIPEs can deadlock a worker mid-
    collective once its 64 KiB buffer fills); worker 0's JSON line is the
    result. Each worker forms the process group itself
    (``mesh.multihost.initialize``: NCCL on cuda, gloo on cpu)."""
    import os
    import socket
    import subprocess
    import tempfile
    from pathlib import Path

    n = args.multihost
    # fail fast, once, before any process exists
    if args.participants % n:
        print(f"error: --participants {args.participants} must be divisible "
              f"by --multihost {n}", file=sys.stderr)
        return 1
    if args.clerks % n:
        print(f"error: --clerks {args.clerks} must be divisible by "
              f"--multihost {n}", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # the workers import this package from where the coordinator did
    path = [str(Path(__file__).resolve().parents[2])]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    env_base = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    worker_argv = list(argv) if argv is not None else sys.argv[1:]
    procs = []
    logs = []
    for pid in range(n):
        env = dict(env_base, SDA_SIM_COORD=f"localhost:{port}",
                   SDA_SIM_NPROC=str(n), SDA_SIM_PID=str(pid))
        log = tempfile.TemporaryFile(mode="w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sda_tpu_torch.cli.sim", *worker_argv],
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
        ))
    rc = 0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        p.wait()
        log.seek(0)
        out = log.read()
        log.close()
        if p.returncode != 0:
            print(out[-2000:], file=sys.stderr)
            rc = p.returncode
        elif pid == 0:
            # collective runtimes (Gloo) chat on stdout; forward only the
            # result line so the one-JSON-line contract holds
            for line in out.splitlines():
                if line.startswith("{"):
                    try:
                        json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    print(line)
    return rc


def _run_load(args) -> int:
    """--load: the capacity drill — N simulated participants through a
    full round over real HTTP (sda_tpu_torch/loadgen/driver.py), reported as
    one BENCH-style JSON line. No mesh/JAX involved: this profile
    measures the transport/store/admission plane, not the kernels."""
    import tempfile

    from ..crypto import sodium
    from ..loadgen import LoadProfile, run_load

    if not sodium.available():
        print("error: --load needs libsodium (real-crypto federated round)",
              file=sys.stderr)
        return 1
    # load is about request volume, not payload mass: a CLI default dim of
    # 9999 would turn every participation into a bulk-transfer benchmark
    dim = min(args.dim, 64)
    if dim != args.dim:
        print(f"note: --load drills traffic, not payload size; clamping to "
              f"--dim {dim}", file=sys.stderr)
    rate, burst = args.load_rate, args.load_burst
    if args.load_overload:
        rate = 8.0 if rate is None else rate
        burst = 2.0 if burst is None else burst
    chaos_rate = args.load_chaos_rate or (args.chaos_rate if args.chaos else 0.0)
    if args.load_fleet:
        from ..loadgen import run_fleet_scaling

        store = args.load_store
        if store == "memory":
            # each OS process would get its own isolated memory store
            print("note: fleet mode needs a cross-process store; using "
                  "--load-store sqlite", file=sys.stderr)
            store = "sqlite"
        record = run_fleet_scaling(
            LoadProfile(
                participants=args.participants,
                dim=dim,
                arrivals=args.load_arrivals,
                target_rps=args.load_rps,
                concurrency=args.load_concurrency,
                seed=args.load_seed,
                store=store,
                max_inflight=args.load_max_inflight,
                rate_limit=rate,
                rate_burst=4.0 if burst is None else burst,
                chaos_rate=chaos_rate,
                churn=args.load_churn,
                codec=args.load_codec,
                async_http=args.async_http,
                device=args.device,
            ),
            nodes=args.load_fleet,
            baseline_nodes=args.load_fleet_baseline,
        )
        print(json.dumps(record))
        ok = (record["exact"] and record["ready"]
              and not record["client_failures"] and record["leaked"] == 0)
        if chaos_rate == 0.0:
            ok = ok and all(r["errors_5xx"] == 0
                            for r in record["rungs"].values())
        return 0 if ok else 1
    with tempfile.TemporaryDirectory() as tmp:
        report = run_load(LoadProfile(
            participants=args.participants,
            dim=dim,
            arrivals=args.load_arrivals,
            target_rps=args.load_rps,
            concurrency=args.load_concurrency,
            seed=args.load_seed,
            store=args.load_store,
            store_path=None if args.load_store == "memory" else f"{tmp}/store",
            max_inflight=args.load_max_inflight,
            rate_limit=rate,
            rate_burst=4.0 if burst is None else burst,
            chaos_rate=chaos_rate,
            churn=args.load_churn,
            codec=args.load_codec,
            async_http=args.async_http,
            device=args.device,
        ))
    _export_trace(args, report)
    print(json.dumps(report))
    ok = report["ready"] and report["exact"] and not report["client_failures"]
    if chaos_rate == 0.0:
        ok = ok and report["errors_5xx"] == 0
    return 0 if ok else 1


def _run_tree(args) -> int:
    """--tree: the hierarchical-aggregation drill — a real multi-level
    round over HTTP (sda_tpu_torch/tree/round.py) plus the population-scale
    simulator record (sda_tpu_torch/tree/sim.py), as one JSON line. No
    mesh/JAX involved: this profile exercises the planner, the relay
    protocol and the lifecycle tree propagation, not the kernels."""
    import tempfile

    import numpy as np

    from ..crypto import sodium
    from ..tree import run_tree_round, simulate_population_round

    if not sodium.available():
        print("error: --tree needs libsodium (real-crypto federated round)",
              file=sys.stderr)
        return 1
    # the real-crypto rung drills the protocol, not throughput: bit-exact
    # evidence needs a handful of groups, not a population (the attached
    # simulator record is the population-scale half)
    participants = min(args.participants, 48)
    dim = min(args.dim, 16)
    if (participants, dim) != (args.participants, args.dim):
        print(f"note: --tree drills the hierarchy, not scale; clamping to "
              f"--participants {participants} --dim {dim} (the simulated "
              f"record covers --tree-sim {args.tree_sim})", file=sys.stderr)
    modulus = 433  # the drill committees' ring (chaos/drill.py)
    rng = np.random.default_rng(args.tree_seed)
    inputs = rng.integers(0, modulus, size=(participants, dim),
                          dtype=np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        report = run_tree_round(
            inputs,
            group_size=args.tree_group_size,
            fanout=args.tree_fanout,
            modulus=modulus,
            sharing=args.tree_sharing,
            masking=args.tree_mask,
            store=args.tree_store,
            store_path=(None if args.tree_store == "memory"
                        else f"{tmp}/store"),
            http=True,
            seed=args.tree_seed,
            dropout_rate=args.tree_dropout,
            dead_clerks_leaf=args.tree_dead_clerks,
            flat_reference=True,
            device=args.device,
        )
    if args.tree_sim:
        report["sim"] = simulate_population_round(
            args.tree_sim, seed=args.tree_seed)
    _export_trace(args, report)
    print(json.dumps(report))
    if args.tree_dead_clerks and args.tree_sharing == "additive":
        # a failed leaf must fail the ROOT with a machine-readable
        # reason naming the leaf — deterministically, not by hanging
        ok = (report["root_state"] == "failed"
              and report.get("failure") is not None
              and "child round" in (report.get("root_reason") or ""))
    elif args.tree_dead_clerks:
        # packed: the leaf degrades, survivors feed up, root bit-exact
        states = [s.get("state") for s in report["node_states"].values()]
        ok = (bool(report["exact"]) and bool(report.get("flat_exact"))
              and "degraded" in states
              and report["root_state"] == "revealed")
    else:
        ok = bool(report["exact"]) and bool(report.get("flat_exact"))
    if args.tree_sim:
        ok = ok and bool(report["sim"]["exact"]) \
            and bool(report["sim"]["bounded"])
    return 0 if ok else 1


def _run_soak(args) -> int:
    """--soak: the continuous-service drill — T tenants x R pipelined
    epochs of recurring rounds through the scheduler/retention plane
    (sda_tpu_torch/service/soak.py), reported as one BENCH-style JSON line.
    No mesh/JAX involved: this profile exercises the service plane —
    recurring scheduling, tenant fairness, retention — not the kernels."""
    import tempfile

    from ..crypto import sodium
    from ..service import SoakProfile, run_soak

    if not sodium.available():
        print("error: --soak needs libsodium (real-crypto federated rounds)",
              file=sys.stderr)
        return 1
    dim = min(args.dim, 16)
    if dim != args.dim:
        print(f"note: --soak drills the service plane, not payload size; "
              f"clamping to --dim {dim}", file=sys.stderr)
    store = args.soak_store
    if args.soak_fleet and store == "memory":
        print("note: fleet mode needs a cross-process store; using "
              "--soak-store sqlite", file=sys.stderr)
        store = "sqlite"
    with tempfile.TemporaryDirectory() as tmp:
        report = run_soak(SoakProfile(
            tenants=args.soak_tenants,
            epochs=args.soak_epochs,
            participants=args.soak_participants,
            dim=dim,
            seed=args.soak_seed,
            store=store,
            store_path=None if store == "memory" else f"{tmp}/store",
            fleet=args.soak_fleet,
            chaos_rate=args.soak_chaos_rate,
            churn=args.soak_churn,
            tenant_rate=args.soak_tenant_rate,
            retain_revealed_s=args.soak_retain,
            device=args.device,
        ))
    _export_trace(args, report)
    print(json.dumps(report))
    retention = report["retention"]
    ok = (
        report["exact"]
        and report["pipelined"]
        and report["leaks"] == 0
        and report["client_failures"] == 0
        and retention["purged_rounds"] >= 1
        # flat-store/RSS verdicts: None means "not measurable here"
        # (e.g. off-Linux RSS) and is not a failure
        and retention["store_rows_flat"] is not False
        and retention["rss_flat"] is not False
    )
    if args.soak_churn:
        churn = report["churn"]
        ok = ok and (churn["participants_resumed"]
                     == churn["participants_churned"])
    if args.soak_fleet:
        ok = ok and report["fleet"]["leaked"] == 0
    return 0 if ok else 1


def _run_analytics(args) -> int:
    """--analytics: the federated-analytics drill — each requested
    encoder kind as its own tenant of recurring scheduler-minted rounds
    over the real stack (sda_tpu_torch/analytics/scenario.py), reported as one
    BENCH-style JSON line whose headline is values/s. No mesh/JAX
    involved: the encoders are integer-vector front-ends to the same
    secure sum every serving drill exercises."""
    import tempfile

    from ..analytics import AnalyticsProfile, expand_kinds, run_analytics
    from ..crypto import sodium

    if not sodium.available():
        print("error: --analytics needs libsodium (real-crypto rounds)",
              file=sys.stderr)
        return 1
    try:
        kinds = expand_kinds(args.analytics)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    store = args.analytics_store
    if args.analytics_fleet and store == "memory":
        print("note: fleet mode needs a cross-process store; using "
              "--analytics-store sqlite", file=sys.stderr)
        store = "sqlite"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            report = run_analytics(AnalyticsProfile(
                kinds=kinds,
                tenants=args.analytics_tenants,
                participants=args.analytics_participants,
                epochs=args.analytics_epochs,
                values_per_device=args.analytics_values,
                domain_size=args.analytics_domain,
                bins=args.analytics_bins,
                width=args.analytics_width,
                depth=args.analytics_depth,
                seed=args.analytics_seed,
                store=store,
                store_path=None if store == "memory" else f"{tmp}/store",
                http=args.analytics_http,
                fleet=args.analytics_fleet,
                modulus_bits=args.analytics_modulus_bits,
                device=args.device,
            ))
        except ValueError as e:
            # FieldSizingError included: a misconfigured encoder is a
            # typed refusal naming the contract, not a traceback
            print(f"error: {e}", file=sys.stderr)
            return 1
    _export_trace(args, report)
    print(json.dumps(report))
    # the analytics verdict: every tenant's every epoch revealed
    # bit-exactly, every decoder stayed within its declared error
    # contract, and nothing leaked across tenants
    ok = (report["exact"]
          and report["bounds_ok"]
          and report["leaks"] == 0
          and report["client_failures"] == 0)
    if args.analytics_fleet:
        ok = ok and report["fleet"]["leaked"] == 0
    return 0 if ok else 1


def _run_fl(args) -> int:
    """--fl: the federated-learning scenario — R rounds of secure FedAvg
    over the full substrate (sda_tpu_torch/fl/scenario.py), reported as
    one BENCH-style JSON line whose headline is rounds-to-target-accuracy.
    Local training and every client's field arithmetic run on
    ``--device``."""
    import tempfile

    from ..crypto import sodium

    if not sodium.available():
        print("error: --fl needs libsodium (real-crypto federated rounds)",
              file=sys.stderr)
        return 1
    from ..fl import FLProfile, run_fl

    with tempfile.TemporaryDirectory() as tmp:
        store = args.fl_store
        if args.fl_fleet and store == "memory":
            print("note: fleet mode needs a cross-process store; using "
                  "--fl-store sqlite", file=sys.stderr)
            store = "sqlite"
        report = run_fl(FLProfile(
            family=args.fl_family,
            participants=args.participants,
            rounds=args.fl_rounds,
            local_steps=args.fl_local_steps,
            batch_size=args.fl_batch,
            shard_size=args.fl_shard,
            eval_size=args.fl_eval,
            lr=args.fl_lr,
            target_accuracy=args.fl_target,
            churn=args.fl_churn,
            dead_clerks=args.fl_dead_clerks,
            dp_sigma=args.fl_dp_sigma,
            dp_delta=args.fl_dp_delta,
            seed=args.fl_seed,
            store=store,
            store_path=None if store == "memory" else f"{tmp}/store",
            http=args.fl_http,
            async_http=args.async_http,
            fleet=args.fl_fleet,
            chaos_rate=args.fl_chaos_rate,
            tree_group_size=args.fl_tree_group,
            poison=args.poison,
            poison_kind=args.poison_kind,
            norm_clip=args.fl_norm_clip,
            tree_robust=args.fl_tree_robust,
            dataset="mnist" if args.fl_mnist else "synthetic",
            mnist_dir=args.fl_mnist,
            clip=args.fl_clip,
            modulus_bits=args.fl_modulus_bits,
            device=args.device,
        ))
    _export_trace(args, report)
    print(json.dumps(report))
    # the scenario verdict: every revealed round bit-exact vs the
    # plaintext quantized sum of its frozen set, the accuracy target
    # reached, nothing leaked or failed — and the failure modes the
    # profile armed actually happened (churned devices all resumed,
    # dead-clerk rounds degraded rather than hanging or failing)
    ok = (report["exact"]
          and report["client_failures"] == 0
          and report.get("leaks", 0) == 0)
    if not args.poison:
        ok = ok and report["reached_target"]
    else:
        # a poisoned run's verdict is PROTOCOL integrity, not learning —
        # an undefended attack is supposed to miss the accuracy target.
        # The drill must have actually exercised the attack: attackers
        # were selected, and the clerks' range sanity saw their uploads
        attack = report.get("attack") or {}
        ok = (ok and attack.get("attackers_total", 0) > 0
              and attack.get("out_of_range_detections", 0) > 0)
    if args.fl_churn and not args.fl_tree_group:
        churn = report["churn"]
        ok = ok and (churn["participants_resumed"]
                     == churn["participants_churned"])
    if args.fl_dead_clerks:
        ok = ok and report["degraded_rounds"] == report["rounds_run"]
    if args.fl_fleet:
        ok = ok and report["fleet"]["leaked"] == 0
    return 0 if ok else 1


def _run_pickup(args) -> int:
    """--pickup: the job-pickup A/B bench (sda_tpu_torch/loadgen/pickup.py) —
    the SAME fixed-seed multi-snapshot round with polling clerks, then
    long-poll clerks, reported as one BENCH-style JSON line whose
    headline is the long-poll enqueue->lease p99 (direction: lower)."""
    from ..crypto import sodium
    from ..loadgen import PickupProfile, run_pickup_bench

    if not sodium.available():
        print("error: --pickup needs libsodium (real-crypto round)",
              file=sys.stderr)
        return 1
    record = run_pickup_bench(PickupProfile(
        snapshots=args.pickup_snapshots,
        poll_interval=args.pickup_interval,
        wait_s=args.pickup_wait,
        seed=args.pickup_seed,
        # both modes serve from the async plane so the A/B isolates the
        # delivery mechanism (polling vs long-poll), not the transport
        async_http=True,
        device=args.device,
    ))
    _export_trace(args, record)
    print(json.dumps(record))
    ok = (record["exact"] and record["value"] is not None
          and (record["speedup_p99"] or 0) >= 1.0)
    return 0 if ok else 1


def _run_connstorm(args) -> int:
    """--connstorm N: hold N open connections against one sdad worker
    subprocess, ping in waves, check RSS and the SIGTERM drain
    (sda_tpu_torch/loadgen/connstorm.py); one BENCH-style JSON line."""
    from ..loadgen import ConnstormProfile, run_connstorm

    record = run_connstorm(ConnstormProfile(
        connections=args.connstorm,
        waves=args.connstorm_waves,
        rss_limit_mb=args.connstorm_rss_limit,
        async_http=not args.connstorm_threaded,
    ))
    print(json.dumps(record))
    return 0 if record["ok"] else 1


def _run_devscale(args) -> int:
    """--devscale: the model-scale device-plane bench
    (sda_tpu_torch/loadgen/devscale.py) — the sharded+streamed+fused round
    at FL-model dimension on ``--device``, one BENCH-style JSON line whose
    headline is elements/sec through the complete round."""
    shards = None
    if args.devscale_shards:
        try:
            p_s, d_s = (int(v) for v in args.devscale_shards.split("x"))
            if p_s <= 0 or d_s <= 0:
                raise ValueError("shard counts must be positive")
        except ValueError:
            print(f"error: --devscale-shards expects PxD with positive "
                  f"counts (e.g. 4x2), got {args.devscale_shards!r}",
                  file=sys.stderr)
            return 1
        shards = (p_s, d_s)

    from ..loadgen import DevScaleProfile, run_devscale

    record = run_devscale(DevScaleProfile(
        dim=args.devscale_dim,
        family=args.devscale_family,
        participants=args.devscale_participants,
        participants_chunk=min(args.devscale_participants, 8),
        p_shards=shards[0] if shards else None,
        d_shards=shards[1] if shards else None,
        dim_tile=args.devscale_tile,
        pallas=args.devscale_pallas,
        rounds=args.devscale_rounds,
        mask=args.devscale_mask,
        seed=args.devscale_seed,
        device=args.device,
    ))
    _export_trace(args, record)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


def _run_chaos(args) -> int:
    """--chaos: the robustness drill — a full federated round over real
    HTTP under deterministic fault injection (sda_tpu_torch/chaos/drill.py),
    reported as the usual one JSON line. No mesh/JAX involved: this
    profile exercises the transport/store/clerk seams, not the kernels."""
    import tempfile

    from ..chaos.drill import run_chaos_drill
    from ..crypto import sodium

    if not sodium.available():
        print("error: --chaos needs libsodium (real-crypto federated round)",
              file=sys.stderr)
        return 1
    # keep the drill small: real sealed-box crypto per participant over
    # HTTP — robustness coverage, not throughput
    participants = min(args.participants, 12)
    dim = min(args.dim, 64)
    if (participants, dim) != (args.participants, args.dim):
        print(f"note: --chaos drills robustness, not scale; clamping to "
              f"--participants {participants} --dim {dim}", file=sys.stderr)
    with tempfile.TemporaryDirectory() as tmp:
        report = run_chaos_drill(
            participants, dim,
            rate=args.chaos_rate,
            seed=args.chaos_seed,
            store=args.chaos_store,
            store_path=None if args.chaos_store == "memory" else f"{tmp}/store",
            extra_spec=args.chaos_spec,
            dead_clerks=args.dead_clerks,
            sharing=args.chaos_sharing,
            brownout_s=args.brownout,
            churn_rate=args.churn,
            async_http=args.async_http,
            device=args.device,
        )
    _export_trace(args, report)
    print(json.dumps(report))
    # brownout recovery rides AND with whichever round verdict applies
    # below (a composed --brownout --dead-clerks drill must satisfy both):
    # the breaker tripped at least once and recovered
    brownout_ok = True
    if args.brownout:
        breaker = report.get("breaker") or {}
        brownout_ok = (breaker.get("times_opened", 0) > 0
                       and breaker.get("time_to_recover_s") is not None)
    churn_ok = True
    if args.churn:
        # the exactly-once verdict: every departure resumed, nothing
        # double-counted, the equivocation probe rejected — and when the
        # seeded plan produced any churn at all, at least one resume
        churn_ok = (
            # the admitted-count audit is best-effort (a chaos'd status
            # poll leaves it None): gate only on an ACTUAL surplus
            report["double_counted"] in (0, None)
            and report["equivocations_undetected"] == 0
            and report["participants_resumed"]
            == report["participants_churned"]
            and (report["participants_churned"] > 0
                 or args.churn < 0.05)
        )
    if args.dead_clerks and args.chaos_sharing == "additive":
        # additive cannot survive a dead clerk: success is a DETERMINISTIC
        # terminal 'failed' with a machine-readable reason (no hang)
        ok = (report.get("round_state") == "failed"
              and bool(report.get("round_reason")))
    elif args.dead_clerks:
        # packed Shamir: success is degraded-then-revealed, bit-exact
        # from the surviving quorum
        states = [s for s, _ in (report.get("round_history") or [])]
        ok = (bool(report["exact"]) and "degraded" in states
              and report.get("round_state") in ("degraded", "revealed"))
    else:
        ok = bool(report["exact"])
    return 0 if ok and brownout_ok and churn_ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .. import obs
    from ..obs import recorder as flight_recorder
    from ..utils import configure_logging, counter_report, phase_report

    configure_logging(args.verbose)
    # one-knob flight recorder: SDA_FLIGHT_RECORDER=DIR spools this
    # process's spans/rounds/metrics; spawned fleet workers inherit the
    # env and spool beside it (sda-trace merges the segments)
    flight_recorder.maybe_install_from_env(node_id="sim")

    if args.analytics and args.fl:
        # two scenario suites, one process: whichever lost the dispatch
        # would be silently ignored and mislabel the run — refuse
        print("error: --analytics and --fl select different scenario "
              "suites; run them as separate invocations",
              file=sys.stderr)
        return 1
    if args.analytics and args.poison:
        print("error: --poison arms the FL adversarial-input drill, not "
              "--analytics (analytics encoders clamp adversarial values "
              "by construction; see docs/analytics.md); drop --poison "
              "or run --fl --poison", file=sys.stderr)
        return 1
    if args.analytics and args.devscale:
        print("error: --analytics and --devscale select different "
              "profiles (scheduled real-crypto rounds vs the model-scale "
              "device-plane bench); run them as separate invocations",
              file=sys.stderr)
        return 1
    if args.poison and not args.fl:
        # a silently ignored attack knob would mislabel the run as an
        # adversarial drill that never attacked anything — refuse
        print("error: --poison arms the FL adversarial-input drill; "
              "add --fl (no other profile trains on device inputs)",
              file=sys.stderr)
        return 1
    if args.analytics:
        return _run_analytics(args)
    if args.load:
        return _run_load(args)
    if args.pickup:
        return _run_pickup(args)
    if args.connstorm:
        return _run_connstorm(args)
    if args.devscale:
        return _run_devscale(args)
    if args.fl:
        return _run_fl(args)
    if args.soak:
        return _run_soak(args)
    if args.tree:
        return _run_tree(args)
    if args.chaos:
        return _run_chaos(args)

    import os

    coord = os.environ.get("SDA_SIM_COORD")
    if args.checkpoint and not args.streaming:
        print("error: --checkpoint applies to the streamed modes; add "
              "--streaming", file=sys.stderr)
        return 1
    if args.multihost and coord is None:
        return _run_multihost(args, argv)

    import numpy as np
    import torch

    from ..device import resolve_device

    # no fallback: without CUDA the default raises here (--device cpu runs
    # the round on the host)
    device = resolve_device(args.device)
    if coord is not None:
        # multihost worker: one device a process (rank r's is cuda:r mod
        # the card count unless --device names one), then the group
        from ..mesh import multihost as _mh

        nproc, pid = int(os.environ["SDA_SIM_NPROC"]), int(
            os.environ["SDA_SIM_PID"])
        slice_devices = [
            torch.device("cuda", r % torch.cuda.device_count())
            if device.type == "cuda" and device.index is None else device
            for r in range(nproc)]
        device = slice_devices[pid]
        _mh.initialize(coord, nproc, pid, device=device)

    from ..fields import numtheory
    from ..mesh import (SimulatedPod, StreamingAggregator,
                        array_block_provider, make_mesh)
    from ..protocol import ChaChaMasking, FullMasking, NoMasking, PackedShamirSharing

    if args.sharing == "basic":
        from ..protocol import BasicShamirSharing

        if args.secrets_per_batch is not None:
            print("note: --secrets-per-batch applies to packed sharing "
                  "only; basic Shamir packs one secret per polynomial",
                  file=sys.stderr)
        p = numtheory.find_prime_with_orders(1, 1, args.modulus_bits)
        t = max(1, (args.clerks - 1) // 2)  # honest majority
        try:
            scheme = BasicShamirSharing(args.clerks, t, p)
        except ValueError as e:
            print(f"error: {e} (--clerks {args.clerks} cannot form a "
                  f"basic-shamir committee)", file=sys.stderr)
            return 1
    else:
        k = args.secrets_per_batch if args.secrets_per_batch is not None else 3
        t, p, w2, w3 = numtheory.generate_packed_params(
            k, args.clerks, args.modulus_bits)
        scheme = PackedShamirSharing(k, args.clerks, t, p, w2, w3)
    survivors = None
    if args.drop_clerks:
        try:
            dropped = {int(i) for i in args.drop_clerks.split(",")}
        except ValueError:
            print(f"error: --drop-clerks expects comma-separated indices, "
                  f"got {args.drop_clerks!r}", file=sys.stderr)
            return 1
        bad = sorted(i for i in dropped if not 0 <= i < args.clerks)
        if bad:
            print(f"error: --drop-clerks indices {bad} outside the "
                  f"committee [0, {args.clerks})", file=sys.stderr)
            return 1
        survivors = tuple(i for i in range(args.clerks) if i not in dropped)
        r = scheme.reconstruction_threshold
        if len(survivors) < r:
            print(f"error: dropping {sorted(dropped)} leaves "
                  f"{len(survivors)} clerks, below the reconstruction "
                  f"threshold {r}", file=sys.stderr)
            return 1
    pod_kwargs = {"surviving_clerks": survivors}
    if args.pallas:
        if device.type != "cuda":
            print("error: --pallas needs a CUDA device (the K1 kernel); "
                  f"this run is on {device.type} (--device {args.device})",
                  file=sys.stderr)
            return 1
        from ..fields.fastfield import SolinasPrime

        if SolinasPrime.try_from(p) is None:
            print(f"error: --pallas requires a Solinas-form prime; the "
                  f"generated prime {p} is not (try a different "
                  f"--modulus-bits)", file=sys.stderr)
            return 1
        pod_kwargs["use_pallas"] = True
    dim = args.dim  # both execution paths auto-pad to the scheme grain
    masking = {
        "none": NoMasking(),
        "full": FullMasking(p),
        "chacha": ChaChaMasking(p, dim, 128),
    }[args.mask]
    rng = np.random.default_rng(0)
    if coord is None:
        inputs = rng.integers(0, 1 << 20, size=(args.participants, dim),
                              dtype=np.int64)
    obs.reset_all()
    # device perf plane: the instrumented stages' call registry + (entry-
    # point opt-in) counted costs feeding the roofline block below.
    # SDA_DEVPROF_COST=0 disables the capture.
    from ..obs import devprof

    devprof.install_monitoring()
    devprof.enable_cost_analysis()
    from ..fields import chacha_device, fused_round

    # K1's and K3's launch counters before the rounds (their plain
    # versions, on the CPU, count none)
    k1, k3 = fused_round.fused_mask_share_combine, chacha_device.chacha_kernel
    k1_0, k3_0 = k1.launches, k3.launches
    wall_start = time.perf_counter()
    seed = 0  # the round seed (the reference's PRNGKey(0))
    if coord is not None:
        from ..mesh import StreamedPod, make_multislice_mesh, multihost as mh

        # the coordinator validated divisibility; every entry of a slice
        # is one committee p-row, and each process's slice is its device
        devs = _devices_per_process(args, nproc)
        mesh = make_multislice_mesh(
            nproc, devs, 1,
            devices=[d for d in slice_devices for _ in range(devs)])
        P_local = args.participants // nproc
        # each worker draws ONLY its own rows — at flagship scale no host
        # can hold the global matrix (that is the point of streamed mode)
        local = np.random.default_rng(1000 + pid).integers(
            0, 1 << 20, size=(P_local, dim), dtype=np.int64
        )
        if args.streaming:
            agg = spod = StreamedPod(
                scheme, masking, mesh=mesh,
                participants_chunk=args.participants_chunk,
                dim_chunk=min(dim, 3 * (1 << 19)),
                **pod_kwargs,
            )
            start = time.perf_counter()
            out = mh.streamed_aggregate_process_local(
                spod, lambda lp0, lp1, d0, d1: local[lp0:lp1, d0:d1],
                local_participants=P_local, dimension=dim, seed=seed,
                checkpoint_path=args.checkpoint,
            )
            elapsed = time.perf_counter() - start
            mode = f"multihost x{nproc} streamed mesh {mesh.devices.shape}"
        else:
            pod = SimulatedPod(scheme, masking, mesh=mesh, **pod_kwargs)
            out = mh.aggregate_process_local(pod, local, seed=seed)
            start = time.perf_counter()
            out = mh.aggregate_process_local(pod, local, seed=seed)
            elapsed = time.perf_counter() - start
            mode = f"multihost x{nproc} simpod mesh {mesh.devices.shape}"
    elif args.streaming:
        agg = StreamingAggregator(
            scheme, masking,
            participants_chunk=args.participants_chunk,
            dim_chunk=min(dim, 3 * (1 << 19)),
            device=device,
            **pod_kwargs,
        )
        start = time.perf_counter()
        out = agg.aggregate_blocks(
            array_block_provider(inputs), inputs.shape[0], inputs.shape[1],
            seed, checkpoint_path=args.checkpoint,
        )
        elapsed = time.perf_counter() - start
        mode = "streaming"
    else:
        # the default mesh spans every CUDA device; a named device (cpu,
        # cuda:N) is a one-shard mesh
        mesh = (None if args.device == "cuda"
                else make_mesh(1, 1, devices=[device]))
        pod = SimulatedPod(scheme, masking, mesh=mesh, **pod_kwargs)  # auto-pads to the mesh grain
        out = pod.aggregate(inputs, seed=seed).cpu().numpy()  # warm round
        start = time.perf_counter()
        out = pod.aggregate(inputs, seed=seed).cpu().numpy()
        elapsed = time.perf_counter() - start
        mode = f"simpod mesh {pod.mesh.devices.shape}"

    result = {
        "mode": mode,
        "participants": args.participants,
        "dim": dim,
        "clerks": args.clerks,
        "prime": p,
        "fast_path": bool(getattr(agg if args.streaming else pod, "_sp", None)),
        "pallas": bool(getattr(agg if args.streaming else pod, "pallas_active", False)),
        "dropped_clerks": (sorted(set(range(args.clerks)) - set(survivors))
                           if survivors else []),
        "seconds": round(elapsed, 4),
        "elements_per_sec": round(args.participants * dim / elapsed, 1),
        "device": str(device),
        "launches": {"k1": k1.launches - k1_0, "k3": k3.launches - k3_0},
    }
    if args.streaming and coord is None:
        # the tiling the round ran: participant x dim tiles, and tile 0's
        # [rows, padded columns], the shape K1 and K3 were launched at
        result["tiles"] = (-(-args.participants // agg.participants_chunk)
                           * -(-dim // agg.dim_chunk))
        result["tile_shape"] = [
            min(agg.participants_chunk, args.participants),
            -(-min(agg.dim_chunk, dim) // agg._grain) * agg._grain]
    if args.verify:
        # int64 column sums: exact while participants * 2^20 < 2^63
        if coord is not None:
            # sum the per-process local sums without any process seeing
            # the global matrix
            local_sums = _allgather_rows(local.sum(axis=0), nproc)
            expected = local_sums.sum(axis=0) % p
        else:
            expected = inputs.sum(axis=0) % p
        result["exact"] = bool((np.asarray(out) == expected).all())
    phases = phase_report()
    if phases:
        result["phases_s"] = {name: round(stat["total_s"], 4)
                              for name, stat in phases.items()}
    # roofline block: counted costs over BOTH rounds (the first is the
    # warm one) against the wall clock of the whole measured region —
    # per-phase ops/bytes/AI plus utilization vs the device's peaks
    # (CPU peaks are nominal, advisory)
    result["roofline"] = devprof.roofline(
        seconds=time.perf_counter() - wall_start, platform=device.type)
    result["xla"] = devprof.compile_totals()
    counters = counter_report()
    if counters:
        result["counters"] = counters
    _export_trace(args, result)
    print(json.dumps(result))
    if coord is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _allgather_rows(row, nproc: int):
    """This process's int64 ``row`` -> the [nproc, len] rows of every
    process (``torch.distributed``: on the process's CUDA device under
    NCCL, on the CPU under gloo)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.from_numpy(np.ascontiguousarray(row, dtype=np.int64)).to(
        device)
    out = torch.empty(nproc * mine.numel(), dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(out, mine)
    return out.cpu().numpy().reshape(nproc, -1)


if __name__ == "__main__":
    sys.exit(main())
