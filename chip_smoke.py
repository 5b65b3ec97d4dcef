#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sda_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout (one ``nvcc``
each, side by side), holds each against its plain PyTorch version on the
card, drives the flagship secure-aggregation round (packed Shamir k=3,
n=8, t=4 over p = 2^29 - 679, full masking, 100 participants x 999,999
uint32 inputs below 2^20) through the port's entry points, checks every
output exactly, and times the fused kernel K1 and both rounds. Then it
runs the kernel probe's entry point (``sda_tpu_torch.benchmarks.
kernel_probe``) at the same width: K5's variants of K1, timed, with the
component budget of K1. K1's instances (``fused_round.INSTANCES``): the
column instances of the ``batch_columns`` layout with internal draws, with
(k, t) compiled in (the main path's k=3, t=4, BasicShamir's k=1, t=3, the
26-clerk committee's k=7, t=8) or set at run time under k + t <= 8 or 16,
masked and unmasked; the external-bits one; the generic one (any other
layout). Each is held to the plain version (the column instances of other
schemes at the main path's sizes too, and timed beside their bounds), and
again into accumulators near p - 1 (the accumulate options a streamed
step runs it with, written in place; the streamed tile's call timed
fresh and into its accumulator), and its registers, spills and resident
warps an SM are printed. Each kernel's
operation bound is counted from the algorithm's work
(``sda_tpu_torch/benchmarks/bounds.py``), beside the count K1's first
CUDA version used; the participant loop's SASS opcode mix (``cuobjdump
-sass``) is printed as a diagnostic. Then the protocol path: the role
crypto (``CryptoModule`` on the card) at the flagship width, P=50,
without transport; the port's host crypto (``crypto/csrc/sodium.c``,
built by the host compiler: sealed boxes and Ed25519 in place of
libsodium) against known answers from libsodium, with sealed-box round
trips at the protocol's bundle sizes and its throughput on the card
machine's host; one round through ``SdaClient``s on the card over the
in-process memory server (P=20 at the same width), with Full masks and
with ChaCha masks on K3 (one expand a participant, the recipient's
combine, both held to the plain version on the round's own seeds), and
the README walkthrough's round over the HTTP server, each revealed
exactly, with the port's field ops counted by the device they ran on.
Then ChaCha seed masks on K3 (``csrc/chacha.cu``): every K3 instance's
ptxas line (a spill fails) and the seed loops' SASS by pipe; K3 held to
its plain version and to the host spec (``fields.chacha``) for both
PRGs, four moduli (one that forces the host replay), several widths and
stream windows, its mask op (the round's ChaCha mask stage in one pass)
at 1, 5 and 250 seeds of 8, 1,000,008 and 3,145,728 columns from three
block counters (one wraps), int32 and int64 out, and in its derived mode
(the seeds' keys from the round seed and the first global id, in the
kernel: 32, 128 and 256 seed bits, ids across 2^32) fresh and into an
accumulator near m - 1; each operation timed beside its bound at the
main path's shapes, the mask op in both modes; the role crypto with ChaCha
masks (P=50 x 1,000,008); ``single_chip_round`` with ChaCha masks (one
mask op); K6, the device block provider's coordinate hash
(``csrc/blockgen.cu``): its ptxas line (a spill fails), held to its
plain version at the streamed tile, the streamed round's ragged last
tile, rows and columns across 2^32, 1 x 1 and an odd width, each at four
bounds, and to the host provider, timed beside its bound; K7, the reveal
(``csrc/reveal.cu``: Lagrange reconstruct and unmask in one pass), and K8,
the residue pass (``csrc/residues.cu``): their ptxas lines (a spill
fails), K7 held to its plain version at every scheme, quorum and mask
layout a path makes, K8 at int64 blocks with the +-2^63 edges, int32 and
uint32, K3's mask op on raw int64 blocks, each timed beside its bound
(K8 also beside ``torch.remainder(x, p).to(torch.int32)``); the streamed
round (``StreamingAggregator(use_pallas=True)``, P=10,000 x 10,000,008
from the device block provider) on K6, K1 and K3's mask op (160 launches
each on raw blocks, no expand, one K7 a dim tile; phase 17's trace of
the same round has no device kernel named remainder), its device peak,
its oracle on K6 with K6 held to plain at the round's first, last and
ragged tiles, and the device-tile clerk fold, each exact, with K3's
mask op at the shapes, block counters and rows the two ChaCha rounds
launched it with held to the plain version
(their masks cancel, so the rounds' sums cannot show them). Then
the Paillier premix on K4 (``csrc/montgomery.cu``): each instance's
ptxas line and resident warps (a spill fails), K4 held to its plain
version and to Python ints at 512-, 2048- and 3072-bit keys, several row
counts and a split small clerk, the flagship clerk column (P=100 x 7,408
ciphertexts of a 2048-bit key) through ``paillier_combine`` with
``SDA_PREMIX_DEVICE=1`` in at most two K4 launches, byte-identical to the
host fold, a homomorphic check on real encryptions, and K4's time beside
its bound, the wrapper's, the plain version's and the host fold's, and
on the same column shape at a 3072-bit key; then the premix inside a live
server (``SdaHttpServer`` over the memory server with
``premix_paillier``, 2048-bit PackedPaillier clerks, the size floor as
shipped): K4 must launch, every clerk job holds one premixed batch, the
reveal is exact, and K4 is held to its plain version at a column the
server folded. Then the bench plane: the
port's bench (``sda_tpu_torch.benchmarks.bench``) in-process at the
flagship width, all three lanes exact, its roofline utilization in
(0, 1.05], K1's launches matching its lanes' calls, K1's device time in
the bench's trace beside the CUDA-event time, the regression gate over the
repo's ``BENCH_r*.json`` with the bench's line as the newest record (a
torch record with no comparable history), the instrumented round against
the bare one with cost capture off and on, and the streamed round once
more with cost capture and the profiler on for its peak device memory,
busy share and device time by part (K3, K1, K6, the rest of the block
provider, the rest), and its device events a tile by kernel name, which
must be the block provider's, the mask op's (and its fold's) and the
fused kernel's alone besides copies; no path of phases 14, 15, 17, 18
and 22 may derive ChaCha seed words on the host. Then the multi-device
modes: ``SimulatedPod`` at the
flagship width on the card's 1x1 mesh and on a virtual 4x2 mesh
(``[cuda:0] * 8``)
with Full, ChaCha and no masks, on K1 and on the plain lane, and a quorum
reveal without clerk 5, each exact with its K1 and K3 launches a round,
and K1 and K3 held to their plain versions at a shard's shape and
offsets; ``run_devscale`` at ``BENCH_r15_devscale.json``'s configuration
(dim 1e8, P=8 on the virtual 4x2 mesh, full masks, K1, seed 20260804)
with its ``DeviceTileSink``-fed lane, exact against the sampled oracle,
its peak device memory against the watermark, K6's launches and K6 held
to plain at its first tile's block; and ``mesh.multihost`` at
world size 1 over NCCL, one round and a streamed round stopped and
resumed from its snapshots, both exact. Then FedAvg on the card: 100
participants train MobileLite (3,731,890 parameters) and the LoRA
adapters of ``LoRAMLP()`` (11,782,400) through ``LocalTrainer`` on the
card, and ``pod_fedavg_round`` aggregates them on K1 over
``SimulatedPod`` (1x1 and virtual 4x2 meshes) and ``StreamedPod``
(virtual 4x2), each round exact over every coordinate against the host
encode of each delta; two MobileLite participants' first SGD steps
held to the same steps on this machine's CPU in the stated float32
setting (``models.precision``), with cuDNN's TF32 beside it;
``run_devscale`` at each family's width; K1 held to its plain version at
those rounds' shard shapes. Then the port's
``sda-sim`` (``sda_tpu_torch.cli.sim.main``) in this process at the
flagship width, each run exact by its own ``--verify``: the pod on K1,
the streamed round on K1 and K3 with ChaCha masks, the quorum reveal
without clerk 6, BasicShamir at 8 clerks and packed Shamir at 26 clerks
with 7 secrets a batch (each on its own column instance of K1), one
multihost worker process over NCCL (its launches counted in the worker),
and the devscale profile at MobileLite's width,
each with its K1 and K3 launches; the drill profiles (load, chaos,
pickup, soak, analytics, tree, fl, and the fleet and forensics drills:
two ``sdad`` worker processes over one sqlite store with chaos on, the
second with churn and the flight recorder, its round explained from the
spools alone) at ``ci.sh``'s sizes, each exact and held to ``ci.sh``'s
assertions; K1 held to its
plain version at the pod's shard, the streamed round's first tile, the
BasicShamir and 26-clerk rounds' shards, the worker's last shard and the
devscale profile's shard, and K3 at the
streamed round's windows, each on the rows and seeds its run drew.
Then the deployment as processes: the port's ``sdad`` over a sqlite
file and ``sda`` processes for a recipient, 8 clerks and 4 participants,
each update of MobileLite's width (3,731,890) from a ``.npy`` file
through ``participate --model --journal`` with ChaCha masks (K3's expand
in each participant process, its combine in the recipient's) and packed
Shamir; participant 0 SIGKILLed once journaled and resumed, ``sdad``
SIGKILLed and restarted on its file, one clerk absent, the mean revealed
bit for bit equal to the updates' own fixed-point oracle, and K3 held to
plain on the round's seeds; then a Paillier round through ``sdad
--premix-paillier`` (K4 in the server process), revealed exactly.
Then the rest of ``ci.sh``: each section no earlier phase runs, through
the port's ``sda-sim`` with ``ci.sh``'s arguments and assertions (the
dead-clerk drill's additive leg beside its Shamir one, the store
brownout, churn on the threaded and the async planes, 10,000 held
connections on one ``sdad`` worker, the JSON and binary wire codecs, the
four poisoning legs, the trace smoke, the device perf plane with and
without ``--pallas``, and the recorder bench), its records through the
port's advisory gate; K1 runs in the perf plane's ``--pallas`` run and is
held to plain at its round's shard. Last, the repo's four ``examples/``
as the port's modules (``sda_tpu_torch/examples/``) at their own sizes:
each ``run`` on the card in this process (the REST FedAvg round's mean
equal to its quantized oracle, the streamed round killed and resumed bit
for bit, the embedded C-core participant's round with K3's expand and
combine held to plain on its seeds, LeNet's secure FedAvg rounds each
equal to the host encode's oracle and its losses to the same run on this
machine's CPU, with cuDNN's TF32 beside them), and all four as ``python -m
processes at once, each exiting 0 with its script's last line.
Prints the card's name and power
limit, one JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and exits non-zero; without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import importlib
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: K1's instances in the SASS (``fused_round.INSTANCES``): the column
#: instances with (k, t) compiled in (the main path's k=3, t=4, BasicShamir's
#: k=1, t=3, the 26-clerk committee's k=7, t=8) and at run time (k + t <= 8
#: or 16), masked and unmasked; the external-bits and the generic ones at
#: k + t <= 8
K1_KERNELS = {"columns": "fused_round_columnsILi3ELi4ELb1EE",
              "columns_unmasked": "fused_round_columnsILi3ELi4ELb0EE",
              "columns_k1t3": "fused_round_columnsILi1ELi3ELb1EE",
              "columns_k1t3_unmasked": "fused_round_columnsILi1ELi3ELb0EE",
              "columns_k7t8": "fused_round_columnsILi7ELi8ELb1EE",
              "columns_k7t8_unmasked": "fused_round_columnsILi7ELi8ELb0EE",
              "columns_r8": "fused_round_boundedILi8ELb1EE",
              "columns_r8_unmasked": "fused_round_boundedILi8ELb0EE",
              "columns_r16": "fused_round_boundedILi16ELb1EE",
              "columns_r16_unmasked": "fused_round_boundedILi16ELb0EE",
              "external": "fused_round_externalILi8EE",
              "generic": "fused_round_kernelILi8EE"}
#: the column instances this script holds beside the main path's (phase 4):
#: instance -> (k, t, clerks, sharing of ``sda-sim``'s argv that makes the
#: scheme): BasicShamir at 8 clerks (``--sharing basic``), the 26-clerk
#: committee (``--secrets-per-batch 7``), and at 26 clerks k=5, t=2 on the
#: run-time shape and k=8, t=7 on the wider one
K1_SCHEMES = {"columns_k1t3": (1, 3, 8, "basic"),
              "columns_k7t8": (7, 8, 26, "packed"),
              "columns_r8": (5, 2, 26, "packed"),
              "columns_r16": (8, 7, 26, "packed")}
#: participants a loop iteration of the main path's instances and of K5
#: (fields/csrc/columns.cuh)
UNROLL = 2

DEVICE = "cuda"
P_MAIN, D_MAIN = 100, 999_999
DIM_TILE = 262_144
#: participants of the protocol round over the in-process server (phase
#: 10): cut from P_MAIN for time only, since the host's sealing and ChaCha
#: draws cost about a second a participant at D_MAIN
P_PROTOCOL = 20
#: participants of the role crypto (phases 9 and 13): cut from P_MAIN for
#: the script's time budget only (each participant's host draws cost
#: 0.2-0.4 s at D_MAIN; the width is never cut)
P_ROLE = 50
#: the port's field ops that the role crypto calls (sda_tpu_torch.fields,
#: looked up there at each call), counted by the device of their inputs
ROLE_OPS = ("combine", "packed_share_from_randomness", "reconstruct",
            "modadd", "modsub", "additive_share_from_randomness")
#: K3's checks (phase 12): moduli (the flagship p is added at run time;
#: 3 * 2^60 + 1 rejects 1 draw in 16, so the host replays every seed) and
#: dimensions of the expansion, seeds of the combine and its timing
K3_MODULI = (433, (1 << 61) - 1, 3 * (1 << 60) + 1)
K3_DIMS = (1, 7, 9, 1000, 1_000_008)
S_COMBINE, S_BIG = 100, 10_000
#: K3's kernels in the SASS, by operation: the instances the main path
#: and the flagship run (the V1 layout; 32-bit residues, m < 2^30; the
#: mask op's int32 out), the mask op's int64 out, and the fold of the
#: chunks' sums. Phase 12 checks every instance for spills.
K3_KERNELS = {"blocks": "chacha_blocks_kernel",
              "expand": "chacha_expand_kernelILb0ELb1EE",
              "combine": "chacha_combine_kernelILb0ELb1EE",
              "mask": "chacha_mask_kernelILb1ELb1EE",
              "mask_int64": "chacha_mask_kernelILb0ELb1EE",
              "fold": "chacha_fold_kernel"}
#: the mask op's checks (phase 12): seeds, widths (one block, the ChaCha
#: phases' and the streamed round's tile) and block counters (one wraps)
K3_MASK_SEEDS = (1, 5, 250)
K3_MASK_DIMS = (8, 1_000_008, 3_145_728)
K3_MASK_COUNTERS = (0, 12_345, (1 << 32) - 2)
#: the mask op's derived mode (phase 12): seed bits and first global ids
#: (the last makes the tile's ids cross 2^32), held at these seeds and
#: widths with and without an accumulator near m - 1
K3_DERIVED_BITS = (32, 128, 256)
K3_DERIVED_BASES = (0, 12_345, (1 << 32) - 3)
K3_DERIVED_SHAPES = ((1, 8), (5, 96), (250, 1_000_008))
#: the ChaCha phases' width (13-14): a whole number of ChaCha blocks
D_CHACHA = 1_000_008
#: the streamed round (phase 15): participants, dimension, participant
#: chunk, from the device block provider (values below 2^20)
P_STREAM, D_STREAM, STREAM_CHUNK = 10_000, 10_000_008, 250
#: its dim tile on an 80 GB card (``StreamingAggregator``'s watermark)
D_TILE = 3_145_728
#: rows and bundles of the device-tile clerk fold (phase 15)
FOLD_ROWS, FOLD_BUNDLES = 100, 4
#: K6's checks (phase 14b), blocks as (p0, rows, d0, cols): the streamed
#: tile, phase 15's ragged last tile, rows across 2^32, columns from within
#: 8 of 2^32, one value, and an odd width whose odd rows start at odd
#: output indices; each at the flagship p (added at run time) and these
#: bounds, on the streamed round's seed
K6_BLOCKS = ((0, STREAM_CHUNK, 0, D_TILE),
             (P_STREAM - STREAM_CHUNK, STREAM_CHUNK, 3 * D_TILE,
              D_STREAM - 3 * D_TILE),
             ((1 << 32) - 3, 7, 5, 100_003), (11, 5, (1 << 32) - 5, 100_003),
             (0, 1, 0, 1), (1, 3, 7, 1_000_003))
K6_BOUNDS = (1 << 20, 0xFFFFFFFF, 433)
K6_SEED = 15
#: the block K6 is held to the host provider on (p0, rows, d0, cols)
K6_HOST_SAMPLE = (P_STREAM - STREAM_CHUNK, 16, 3 * D_TILE, 4_096)
#: K6's kernel in the SASS
K6_KERNEL = "blockgen_kernel"
#: K7's checks (phase 14c): (case, sda-sim's sharing, secrets, clerks,
#: survivors or None, B, d): the flagship tile and odd shapes, BasicShamir,
#: the 26-clerk committee, sda-sim's run-time shapes (r = 80 at
#: ``--clerks 80``: more rows than the kernel sums between two folds) and
#: quorum subsets; a ``None`` sharing is k secrets from that many rows of a
#: random matrix (k = 20: more secrets than a thread sums)
K7_CASES = (
    ("flagship tile", "packed", 3, 8, None, D_MAIN // 3, D_MAIN),
    ("flagship, odd B, d % k != 0", "packed", 3, 8, None, 1001, 3001),
    ("flagship quorum without clerk 5", "packed", 3, 8,
     (0, 1, 2, 3, 4, 6, 7), 1001, 3002),
    ("BasicShamir, 8 clerks", "basic", 1, 8, None, 3001, 3001),
    ("BasicShamir quorum", "basic", 1, 8, (7, 5, 3, 1), 257, 257),
    ("packed k=7, 26 clerks", "packed", 7, 26, None, 1001, 7001),
    ("packed k=7 quorum of 15", "packed", 7, 26, tuple(range(1, 26, 2)) +
     (0, 2), 429, 3000),
    ("--secrets-per-batch 1", "packed", 1, 8, None, 999, 999),
    ("--secrets-per-batch 2", "packed", 2, 8, None, 1000, 1999),
    ("--sharing basic --clerks 26", "basic", 1, 26, None, 3001, 3001),
    ("k=10 from 32 random rows", None, 10, 32, None, 301, 3003),
    ("--clerks 80", "packed", 3, 80, None, 1001, 3001),
    ("--clerks 80 quorum of 61", "packed", 3, 80, tuple(range(0, 80, 2)) +
     tuple(range(1, 42, 2)), 1001, 3003),
    ("--sharing basic --clerks 80", "basic", 1, 80, None, 257, 257),
    ("k=20 from 70 random rows", None, 20, 70, None, 301, 6011),
)
#: K7 timed (phase 14c): (case, r, B, k, d, mask layout): the flagship
#: tile's reveal (phase 5), a streamed finale's tile and a model-scale
#: shard's (phase 19: [8, 10,984,168] of the 1e8 rung's d column)
K7_TIMED = (("flagship tile", 8, D_MAIN // 3, 3, D_MAIN, "batched"),
            ("streamed finale", 8, 1 << 20, 3, 3 << 20, "flat"),
            ("model-scale shard", 8, 10_984_168, 3, 32_952_504, "flat"))
#: K8's checks and timing (phase 14c): blocks as (dtype, rows, cols,
#: offset of a strided view or None); the last is timed with the library
#: call beside it
K8_BLOCKS = (("int64", 7, 1003, None), ("int64", 3, 1_000_003, 5),
             ("int32", 5, 100_003, 3), ("uint32", 100, 999_999, None),
             ("int32", 1, 9, None), ("int64", STREAM_CHUNK, D_TILE, None))
#: K7's and K8's kernels in the ptxas log
K7_KERNELS = ("reveal_kernelILi4EE", "reveal_kernelILi16EE")
K8_KERNELS = ("residues_kernelIxEE", "residues_kernelIiEE",
              "residues_kernelIjEE")
#: timed rounds of the pod phase (18)
POD_REPS = 5
#: the model-scale rung of ``BENCH_r15_devscale.json`` (phase 19)
DEVSCALE_DIM = 100_000_000
#: the streamed multihost round (phase 20): participant and dim chunks,
#: and the blocks fed before the provider stops it
MH_CHUNK, MH_DIM_CHUNK, MH_STOP = 32, 262_144, 7
#: the participant chunk of the streamed sim run (phase 22)
SIM_CHUNK = 50
#: ``ci.sh``'s fleet drill (phase 22(f)): two ``sdad`` workers over one
#: sqlite store, chaos on; its forensics drill adds churn
FLEET_DRILL = ["--load", "--participants", "24", "--dim", "4",
               "--load-arrivals", "closed", "--load-concurrency", "8",
               "--load-seed", "20260803", "--load-store", "sqlite",
               "--load-fleet", "2", "--load-chaos-rate", "0.05"]
#: FedAvg on the card (phase 21): participants, local SGD steps and
#: learning rate of each family (MobileLite's SGD diverges at
#: ``fl.FLProfile``'s 0.1), training examples a participant, batch, eval
#: examples and the codec's clip (``fl.FLProfile``'s defaults)
P_FEDAVG = 100
FEDAVG_STEPS = {"mobilelite": 4, "lora": 2}
FEDAVG_LR = {"mobilelite": 0.01, "lora": 0.1}
FEDAVG_SHARD, FEDAVG_BATCH, FEDAVG_EVAL = 64, 16, 256
FEDAVG_CLIP = 1.0
#: the card's float32 training held to this machine's CPU from the same
#: weights (``models.precision``: no TF32): LeNet's FedAvg losses (phase
#: 25) and the losses of two MobileLite participants' first SGD steps
#: (phase 21). Both sides run float32; only the order of their sums
#: differs (LeNet's losses agreed within 2e-7 on the card's machine), so
#: the tolerances are far below TF32's ~1e-3. Turns of each TF32 A/B.
LENET_LOSS_TOL = 1e-5
MOBILELITE_LOSS_TOL = 1e-4
PRECISION_TURNS = 3
#: K4's checks (phase 16): Paillier key sizes (n^2 of 32, 128 and 192
#: limbs, each filling a group instance), premix row counts (at 256 lanes
#: the larger ones split a lane's rows) and lanes; the split path of a small
#: clerk (33 rows of 4 lanes)
K4_KEY_BITS = (512, 2048, 3072)
K4_ROWS = (1, 2, 3, 16, 33)
K4_LANES = 256
K4_SPLIT_CASE = (33, 4)
#: the wide instance's check: an odd modulus of 513 limbs (above the
#: group instances' 512), folds of these row counts at K4_LANES lanes and
#: the split path
K4_WIDE_LIMBS, K4_WIDE_ROWS = 513, (3, 33)
#: the key of K4's second timed column (n^2 of 192 limbs)
WIDE_KEY_BITS = 3072
#: the flagship clerk column (phase 16): P=100 participants, each sending a
#: clerk B = ceil(333,333 / 45) ciphertexts of a 2048-bit key (packed
#: Shamir k=3 of d=999,999 gives a clerk 333,333 shares; the CLI packs 45
#: windows of 29 + 16 bits a plaintext)
P_PREMIX, B_PREMIX, PREMIX_KEY_BITS = 100, 7408, 2048
SHARES_PREMIX, PREMIX_WINDOW, PREMIX_VALUE_BITS = 333_333, 45, 29
#: target seconds of the bench's marginal chains (phase 17; the chains
#: stop at 64 rounds), and the turns of its instrumented-round A/B
BENCH_SECONDS = 2.0
AB_TURNS = 24
#: known answers of the port's host crypto, from libsodium 1.0.18
#: (``tests/test_torch_sodium.py`` holds them to it): crypto_scalarmult_base
#: of bytes(range(32)); crypto_sign_seed_keypair of bytes(range(32, 64)) and
#: its detached signature of KAT_MESSAGE; KAT_MESSAGE sealed to KAT_BOX_PK
#: with the ephemeral secret key bytes(range(64, 96))
KAT_MESSAGE = b"sda-tpu-torch host crypto known answer"
KAT_BOX_PK = "8f40c5adb68f25624ae5b214ea767a6ec94d829d3d7b5e1ad1ba6f3e2138285f"
KAT_SIGN_PK = "29acbae141bccaf0b22e1a94d34d0bc7361e526d0bfe12c89794bc9322966dd7"
KAT_SIG = ("f13a1ec2f0048c0aea663d60a914704020066bc54e1250cbf10bd0e45b1f1b45"
           "3ab2a8c23485b364ab31f4cc75c7500a6a8684ee4509ff9b7e07749d9113c80a")
KAT_SEALED = (
    "79a631eede1bf9c98f12032cdeadd0e7a079398fc786b88cc846ec89af85a51a"
    "5a327140a0a87a0c6c2e38b2113be4c7ba3ce0546deaeba3ef57306c10ff56d4"
    "cb8065e1427bfa4d933612f7ee600e474bda67c23a2b")
#: sealed-box sizes of the host-crypto checks: empty, one byte, about a
#: clerk's share bundle and the recipient's mask bundle of phase 10
#: (varints of 333,333 packed shares and of 999,999 Full masks below 2^29);
#: the timing's bundle, its repeats, and the sign/verify repeats
SEAL_SIZES = (0, 1, 1_500_000, 4_000_000)
SEAL_BUNDLE, SEAL_REPS, SIGN_REPS = 1_500_000, 20, 200
#: the live-server premix (phase 16b): participants and dimension of the
#: round (modulus 433, 3 additive clerks) and its committee's
#: PackedPaillier scheme (2048-bit keys, 60 windows of 32 bits a
#: plaintext, 16-bit values): each clerk column is P x ceil(D / 60) = 272
#: ciphertexts, above encryption._DEVICE_PREMIX_MIN_MODMULS = 64
P_PREMIX_SERVER, D_PREMIX_SERVER = 8, 2000
PREMIX_SERVER_SCHEME = (60, 32, 16, 2048)
#: the deployment as processes (phase 23): participants (4, cut from 8 so
#: the whole script keeps a margin under 900 s; the width is never cut)
#: and their update width (MobileLite's parameters,
#: ``models/families.py``), the aggregation modulus (about 20 bits: 4
#: summands of 16 fractional bits clip at ~2.0, far above the updates'
#: N(0, 0.01) draws, and the packed Shamir prime admits 512 summands),
#: committee size, the absent clerk, the seed of the updates, and the most
#: processes run at once
P_DEPLOY, D_DEPLOY, M_DEPLOY = 4, 3_731_890, 1_048_573
DEPLOY_CLERKS, DEPLOY_ABSENT, DEPLOY_BITS, DEPLOY_SEED = 8, 3, 16, 2026
DEPLOY_POOL = 8
#: its Paillier leg: phase 16b's sizes through ``sdad --premix-paillier``
#: (3 clerks, CLI-packed 2048-bit keys: 64 windows a plaintext, so each
#: clerk column is 8 x 32 ciphertexts, above the floor of 64)
P_DEPLOY_PAILLIER, D_DEPLOY_PAILLIER, DEPLOY_PAILLIER_BITS = 8, 2000, 2048
#: seconds a role process may take before the phase fails
ROLE_TIMEOUT_S = 300
#: the README walkthrough's round: three participants' 10-dim inputs
WALKTHROUGH = ([0, 0, 0, 1, 1, 1, 2, 2, 2, 3], [0, 1, 1, 1, 1, 2, 2, 3, 3, 3],
               [0, 1, 1, 2, 2, 3, 2, 3, 3, 4])


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median wall time of ``fn()`` in ms, each run ended by a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(label: str, fn, reps: int = 3) -> dict:
    """Print the device time by operation over ``reps`` calls of ``fn()``
    (torch.profiler; the profiler's own cost inflates the wall time), and
    the device's busy share of the window; returns the wall and busy ms a
    call and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sda_tpu_torch import utils

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ranges = set(utils.phase_report())
    rows = []
    for e in prof.key_averages():
        # device-side entries only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched, and a user range
        # (a ``timed_phase``) on the device's timeline spans them
        if e.device_type != DeviceType.CUDA or e.key in ranges or getattr(
                e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    events = sum(r[1] for r in rows) / reps
    print(f"  profile of {label}: wall {wall_us / reps / 1e3:.3f} ms/round "
          f"under the profiler, device busy {busy / reps / 1e3:.3f} "
          f"ms/round, busy share {busy / wall_us:.3f}, {events:.1f} device "
          "events (kernels and copies) a round")
    for dev_us, count, key in rows[:8]:
        print(f"    {dev_us / reps / 1e3:9.4f} ms/round {count / reps:6.1f}"
              f" calls/round  {key[:100]}")
    return {"wall_ms": wall_us / reps / 1e3, "busy_ms": busy / reps / 1e3,
            "busy_share": busy / wall_us, "device_events": events}


class DeviceCounts:
    """While entered, wraps the port's field ops ``ROLE_OPS`` to count
    their calls by the device type of their tensor arguments."""

    def __init__(self):
        from sda_tpu_torch import fields

        self.fields = fields
        self.calls = {name: collections.Counter() for name in ROLE_OPS}

    def _wrap(self, name, fn):
        import torch

        def counted(*args, **kwargs):
            self.calls[name].update(
                {a.device.type for a in list(args) + list(kwargs.values())
                 if isinstance(a, torch.Tensor)})
            return fn(*args, **kwargs)
        return counted

    def __enter__(self):
        self._saved = {n: getattr(self.fields, n) for n in ROLE_OPS}
        for name, fn in self._saved.items():
            setattr(self.fields, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.fields, name, fn)

    def check(self, label, device_type, required):
        """Each op of ``required`` ran on ``device_type`` and no op ran on
        another device."""
        for name in required:
            _check(self.calls[name][device_type] > 0,
                   f"{label}: {name} never ran on {device_type}")
        for name, by_dev in self.calls.items():
            other = {d: c for d, c in by_dev.items() if d != device_type}
            _check(not other, f"{label}: {name} ran on {other}")
        return {name: dict(c) for name, c in self.calls.items() if c}


def _flagship():
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    return PackedShamirSharing(3, 8, t, p, w2, w3), FullMasking(p), p


def _sim_scheme(secrets, clerks, sharing):
    """The scheme ``sda-sim`` runs with ``--sharing SHARING --clerks
    CLERKS`` (and ``--secrets-per-batch SECRETS`` when packed) at its
    default ``--modulus-bits 28``."""
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.protocol import BasicShamirSharing, PackedShamirSharing

    if sharing == "basic":
        return BasicShamirSharing(clerks, max(1, (clerks - 1) // 2),
                                  numtheory.find_prime_with_orders(1, 1, 28))
    t, p, w2, w3 = numtheory.generate_packed_params(secrets, clerks, 28)
    return PackedShamirSharing(secrets, clerks, t, p, w2, w3)


def _phases(utils):
    return {name: stat["total_s"]
            for name, stat in utils.phase_report().items()}


def role_crypto(dev, P, D, seed=0, masking=None):
    """Phases 9 and 13: the role crypto at the flagship width, no
    transport, with Full masking or the given one. Each of P participants
    masks and shares, the n clerk combiners and the mask combiner fold, the
    recipient reconstructs from all shares and from a dropout's survivors
    and unmasks; both reveals must equal the column sum. ChaCha masks go
    through K3 on a CUDA device, which must have launched. Returns the
    phase's JSON record."""
    import numpy as np

    from sda_tpu_torch import utils
    from sda_tpu_torch.crypto import CryptoModule, MemoryKeystore, rand
    from sda_tpu_torch.protocol import ChaChaMasking
    from sda_tpu_torch.utils import timed_phase

    scheme, full, p = _flagship()
    masking = masking or full
    seeded = isinstance(masking, ChaChaMasking)
    n = scheme.share_count
    cm = CryptoModule(MemoryKeystore(), device=dev)
    inputs = np.random.default_rng(seed).integers(0, 1 << 20, size=(P, D))
    expect = inputs.sum(0) % p
    utils.reset_phase_report()
    per_clerk, masks = [[] for _ in range(n)], []
    k3 = _k3_reset()
    with DeviceCounts() as counts:
        t0 = time.perf_counter()
        for x in inputs:   # a masker and a generator a call, as a client
            with timed_phase("participant.mask"):
                mask, masked = cm.new_secret_masker(masking).mask(x)
            with timed_phase("participant.share"):
                shares = cm.new_share_generator(scheme).generate(masked)
            masks.append(mask)
            for clerk, share in zip(per_clerk, shares):
                clerk.append(share)
        combined = []
        for clerk in per_clerk:
            with timed_phase("clerk.combine"):
                combined.append(cm.new_share_combiner(scheme).combine(clerk))
        del per_clerk
        with timed_phase("recipient.combine_masks"):
            mask_total = cm.new_mask_combiner(masking).combine(masks)
        reveals = {}
        for label, survivors in (("all", range(n)),
                                 ("dropout", [i for i in range(n) if i != 2])):
            with timed_phase("recipient.reconstruct"):
                total = cm.new_secret_reconstructor(scheme, D).reconstruct(
                    [(i, combined[i]) for i in survivors])
            with timed_phase("recipient.unmask"):
                out = cm.new_secret_unmasker(masking).unmask(mask_total, total)
            _check(out.dtype == np.int64 and out.shape == (D,),
                   f"role crypto ({label}): output {out.dtype}{out.shape}")
            _check(np.array_equal(out, expect),
                   f"role crypto ({label}): != column sum mod p")
            reveals[label] = len(list(survivors))
        wall = time.perf_counter() - t0
    # a ChaCha masker adds and subtracts on the host, as the reference's
    calls = counts.check("role crypto", dev.type,
                         ROLE_OPS[:3] if seeded else ROLE_OPS[:5])
    k3_launches = dict(k3.op_launches)
    if seeded and dev.type == "cuda":
        _check(k3_launches["expand"] >= P and k3_launches["combine"] >= 1,
               f"role crypto (ChaCha): K3 launches {k3_launches}")
    return {"stage": "role_crypto", "participants": P, "dim": D,
            "masking": type(masking).__name__,
            "rand_mode": rand.get_mode(), "survivors": reveals, "exact": True,
            "wall_s": wall, "phases_s": _phases(utils), "device_calls": calls,
            "k3_launches": k3_launches}


def _k3_reset():
    from sda_tpu_torch.fields import chacha_device

    k3 = chacha_device.chacha_kernel
    k3.launches = k3.derived_launches = 0
    k3.op_launches.update(dict.fromkeys(chacha_device.OPS, 0))
    return k3


#: calls of the port's ChaCha seed-word derivation (the plain version of
#: K3's derived keys), by the paths this script drives; holds call
#: ``_SEED_WORDS["plain"]``, which is not counted
_SEED_WORDS = {"plain": None, "calls": 0}


def _count_seed_words():
    """Wrap ``chacha_device.chacha_seed_words`` and its ``simpod`` name in
    a counter (once); returns the count so far. On a card no path may call
    it: K3's mask op derives the keys itself."""
    from sda_tpu_torch.fields import chacha_device
    from sda_tpu_torch.mesh import simpod

    if _SEED_WORDS["plain"] is None:
        plain = _SEED_WORDS["plain"] = chacha_device.chacha_seed_words

        def counted(*args, **kwargs):
            _SEED_WORDS["calls"] += 1
            return plain(*args, **kwargs)
        chacha_device.chacha_seed_words = counted
        simpod._chacha_seed_words = counted
    return _SEED_WORDS["calls"]


def _seed_words(round_seed, ids, bits):
    """The seed words of participants ``ids`` (the plain version, not
    counted by ``_count_seed_words``)."""
    from sda_tpu_torch.fields import chacha_device

    fn = _SEED_WORDS["plain"] or chacha_device.chacha_seed_words
    return fn(round_seed, ids, bits)


def _host_window(seed, counter0, d, m):
    """The CHACHA_PRG_V1 draws [8*counter0, 8*counter0 + d) mod m of the
    host spec's block function (numpy), without rejection."""
    import numpy as np

    from sda_tpu_torch.fields import chacha

    words = chacha.chacha_block_words(seed, counter0, d // 8).reshape(-1)
    v = (words[1::2].astype(np.uint64) << np.uint64(32)) | words[0::2]
    return (v % np.uint64(m)).astype(np.int64)


def _k3_window(case, dev, round_seed, p0, rows, counter0, width, modulus,
               seed_bits=128, x=None, out_dtype=None, acc=False):
    """K3's mask op at a shape and block counter a round launched it with,
    in the derived mode the round ran (the keys of participants ``p0 ..``
    under ``round_seed`` derived in the kernel), on ``x`` (the round's
    residues there; random ones below the modulus when None) and, with
    ``acc``, into an accumulator of random residues (as a streamed step
    adds), held to the plain version (``chacha_seed_words`` then
    ``mask_plain``) with ``torch.equal``: the masked rows as ``out_dtype``
    (int64 when None) and the mask sum. ChaCha masks cancel inside a
    round, so the round's exact sum cannot see a wrong window; this check
    can. Returns the max |error| (0 when equal)."""
    import torch

    from sda_tpu_torch.fields import chacha_device as cd

    ids = p0 + torch.arange(rows, dtype=torch.int64, device=dev)
    sw = _seed_words(round_seed, ids, seed_bits)
    gen = torch.Generator(device=dev).manual_seed(p0 + counter0)
    if x is None:
        x = torch.randint(0, modulus, (rows, width), dtype=torch.int64,
                          device=dev, generator=gen)
    dtype = torch.int64 if out_dtype is None else out_dtype
    acc_got = acc_want = None
    if acc:
        acc_got = torch.randint(0, modulus, (width,), dtype=torch.int64,
                                device=dev, generator=gen)
        acc_want = acc_got.clone()
    got = cd.mask_residues_derived(round_seed, p0, seed_bits, counter0, x,
                                   modulus=modulus, out_dtype=dtype,
                                   acc_mask=acc_got)
    want = cd.mask_plain(sw, counter0, x, modulus, dtype, acc_want)
    _check(not acc or got[1].data_ptr() == acc_got.data_ptr(),
           f"{case}: the mask op's accumulate did not write in place")
    err = 0
    for g, w, what in zip(got, want, ("masked rows", "mask sum")):
        _check(g.shape == w.shape and g.dtype == w.dtype,
               f"{case}: K3 mask {what} {g.dtype}{tuple(g.shape)} vs "
               f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            err = max(err, int((g.to(torch.int64) - w).abs().max()))
    _check(err == 0, f"{case}: K3 mask [{rows}, {width}] of participants "
           f"{p0}.. at counter0={counter0} != plain (max |err| {err})")
    print(f"  {case}: K3 mask [{rows}, {width}] {dtype} of participants "
          f"{p0}.. at counter0={counter0}, derived keys"
          f"{', into an accumulator' if acc else ''}: equal to plain")
    return err


def _k3_sass(lib_path, cuobjdump):
    """Phase 12: each strip kernel's seed loop (one ChaCha block a seed)
    in SASS: its instruction count, its opcodes, the quarter-round's
    rotates (SHF, PRMT), xors (LOP3) and adds (IADD3 on the ALU pipe,
    IMAD on the FMA pipe) and its instructions by pipe. Returns {op: the
    record}."""
    from sda_tpu_torch.utils import sass

    out = {}
    for op in ("expand", "combine", "mask"):
        kernel = K3_KERNELS[op]
        try:
            lines = sass.loop_instructions(lib_path, cuobjdump, kernel,
                                           innermost=True)
        except (LookupError, ValueError) as exc:
            print(f"  K3 {op} seed loop: not found ({exc})")
            continue
        mix = collections.Counter(op_ for op_, _ in lines)
        heads = collections.Counter(o.split(".")[0] for o in mix.elements())
        rec = out[op] = {
            "instructions": sum(mix.values()),
            "pipes": sass.pipe_mix(lines),
            **{h: heads[h] for h in ("SHF", "PRMT", "LOP3", "IADD3",
                                     "IMAD")},
            "IMAD.IADD": mix["IMAD.IADD"],
            "opcodes": dict(mix.most_common(16))}
        print(f"  K3 {op} seed loop ({kernel}), a block a seed: "
              f"{rec['instructions']} instructions; pipes {rec['pipes']}; "
              f"SHF {rec['SHF']}, PRMT {rec['PRMT']}, LOP3 {rec['LOP3']}, "
              f"IADD3 {rec['IADD3']}, IMAD {rec['IMAD']} (IMAD.IADD "
              f"{rec['IMAD.IADD']}); "
              + ", ".join(f"{o} {c}" for o, c in mix.most_common(12)))
    return out


def _k3_mask_holds(dev, p, equal, seeds=K3_MASK_SEEDS, dims=K3_MASK_DIMS,
                   counters=K3_MASK_COUNTERS, timed=(250, 3_145_728,
                                                     12_345)):
    """Phase 12: K3's mask op against its plain version with
    ``torch.equal`` at every (seeds, width, block counter), int32 and
    int64 out, on canonical residues below p. Returns the plain version's
    time (ms, one call) at ``timed``."""
    import torch

    from sda_tpu_torch.fields import chacha_device as cd

    gen = torch.Generator(device=dev).manual_seed(12)
    plain_ms = None
    for S in seeds:
        for d in dims:
            sw = torch.randint(0, 1 << 32, (S, 8), dtype=torch.int64,
                               device=dev, generator=gen)
            x = torch.randint(0, p, (S, d), dtype=torch.int64, device=dev,
                              generator=gen)
            for c0 in counters:
                t0 = time.perf_counter()
                want = cd.mask_plain(sw, c0, x, p, torch.int64)
                _sync(dev)
                if (S, d, c0) == timed:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                for dtype in (torch.int32, torch.int64):
                    got = cd.chacha_kernel("mask", sw, counter0=c0, x=x,
                                           modulus=p, out_dtype=dtype)
                    case = f"mask S={S} d={d} counter0={c0} {dtype}"
                    _check(got[0].dtype == dtype,
                           f"{case}: masked {got[0].dtype}")
                    equal(f"{case} masked", got[0], want[0])
                    equal(f"{case} sum", got[1], want[1])
                    del got
                del want
            del sw, x
            _empty_cache(dev)
        print(f"  mask S={S}: d in {list(dims)} at counter0 in "
              f"{list(counters)}, int32 and int64 out: equal to plain")
    return plain_ms


def _k3_derived_holds(dev, p, equal, bits=K3_DERIVED_BITS,
                      bases=K3_DERIVED_BASES, shapes=K3_DERIVED_SHAPES):
    """Phase 12: K3's mask op in its derived mode (the seeds' keys from the
    round seed and the first global id, in the kernel) against its plain
    version (``chacha_seed_words`` then ``mask_plain``) with
    ``torch.equal`` at every first id and shape, every seed width (the
    widest shape at 128 bits only), int32 and int64 out, fresh and into an
    accumulator near m - 1 (written in place)."""
    import torch

    from sda_tpu_torch.fields import chacha_device as cd

    gen = torch.Generator(device=dev).manual_seed(20)
    round_seed = (1 << 62) - 12_345  # both key words in use
    cases = 0
    for S, d in shapes:
        x = torch.randint(-(1 << 62), 1 << 62, (S, d), dtype=torch.int64,
                          device=dev, generator=gen)  # raw, as a step's
        near = p - 1 - torch.randint(0, 3, (d,), dtype=torch.int64,
                                     device=dev, generator=gen)
        for b in (bits if S * d < 1 << 20 else (128,)):
            for base in bases:
                ids = base + torch.arange(S, dtype=torch.int64, device=dev)
                c0 = (base * 7) & 0xFFFFFFFF
                masked, total = cd.mask_plain(_seed_words(round_seed, ids, b),
                                              c0, x, p, torch.int64)
                for dtype in (torch.int32, torch.int64):
                    for acc in (False, True):
                        case = (f"derived mask S={S} d={d} bits={b} "
                                f"pid_base={base} {dtype}"
                                f"{' acc' if acc else ''}")
                        a_got = near.clone() if acc else None
                        got = cd.mask_residues_derived(
                            round_seed, base, b, c0, x, modulus=p,
                            out_dtype=dtype, acc_mask=a_got)
                        _check(got[0].dtype == dtype,
                               f"{case}: masked {got[0].dtype}")
                        _check(not acc or got[1].data_ptr()
                               == a_got.data_ptr(),
                               f"{case}: accumulator not written in place")
                        equal(f"{case} masked", got[0], masked)
                        equal(f"{case} sum", got[1],
                              (near + total) % p if acc else total)
                        cases += 1
                        del got
                del masked, total
        del x
        _empty_cache(dev)
    print(f"  derived mask: {cases} cases (bits {list(bits)}, pid_base "
          f"{list(bases)}, shapes {list(shapes)}, int32 and int64, with and "
          "without an accumulator near m - 1): equal to plain")


def chacha_kernels(dev, p, lib_path, ptxas_log, cuobjdump, dims=K3_DIMS,
                   s_combine=S_COMBINE, s_big=S_BIG, d_big=D_CHACHA,
                   mask_seeds=K3_MASK_SEEDS, mask_dims=K3_MASK_DIMS,
                   tile=(STREAM_CHUNK, D_TILE),
                   derived_shapes=K3_DERIVED_SHAPES):
    """Phase 12: K3 against its plain version (on the same device) and the
    host spec (numpy ``fields.chacha``, or the native C++ for the combine
    at full width), exactly, for both PRGs, and its mask op against its
    plain version at the main path's shapes; then each operation's time
    beside its bound, its ptxas line and its seed loop's SASS. Returns
    {"ops": {op: its record}, "max_abs_err", "check_launches", ...}."""
    import numpy as np
    import torch

    from sda_tpu_torch import native
    from sda_tpu_torch.benchmarks.bounds import k3_bound
    from sda_tpu_torch.fields import chacha, chacha_device as cd
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    on_card = dev.type == "cuda"
    ptxas, loops = {}, {}
    if on_card:
        info = sass.ptxas_info(ptxas_log)
        for key, ptx in info.items():  # every instance, both layouts
            _check(not sass.spills(ptx), f"{key} spills: {'; '.join(ptx)}")
        _check(len(info) == 14, f"K3: {len(info)} kernels in ptxas's log, "
               "want 14 (blocks, fold, 4 instances of each strip kernel)")
        for name, kernel in K3_KERNELS.items():
            ptx = next((v for key, v in info.items() if kernel in key), None)
            _check(ptx is not None, f"{kernel}: no ptxas line")
            ptxas[name] = ptx
            print(f"  K3 {name} ({kernel}): {'; '.join(ptx)}")
        print(f"  K3: {len(info)} kernels, none spills")
        loops = _k3_sass(lib_path, cuobjdump)
    rng = np.random.default_rng(12)
    max_err = 0
    k3 = _k3_reset()

    def equal(case, got, want):
        nonlocal max_err
        got = torch.as_tensor(got).to(torch.int64)
        want = torch.as_tensor(want).to(got.device, torch.int64)
        _check(got.shape == want.shape, f"{case}: {tuple(got.shape)} vs "
               f"{tuple(want.shape)}")
        if not torch.equal(got, want):
            max_err = max(max_err, int((got - want).abs().max()))
            _fail(f"{case}: not equal (max |err| {max_err})")

    def seed_words(S):
        return [list(map(int, r)) for r in rng.integers(0, 1 << 32, (S, 4))]

    moduli = (K3_MODULI[0], p) + K3_MODULI[1:]
    for prg in (chacha.CHACHA_PRG_V1, chacha.CHACHA_PRG_RAND03):
        for m in moduli:
            replayed = 0
            for d in dims:
                seed = seed_words(1)[0]
                sw = cd._seed_matrix([seed], dev)
                got = cd.chacha_kernel("expand", sw, dimension=d, modulus=m,
                                       prg=prg)
                want = cd.expand_plain(sw, 0, d, m, prg)
                equal(f"expand {prg} m={m} d={d} vs plain", got[0], want[0])
                equal(f"expand {prg} m={m} d={d} flags", got[1], want[1])
                replayed += int(got[1][0])
                equal(f"expand_mask {prg} m={m} d={d} vs host spec",
                      cd.expand_mask(seed, d, m, prg=prg, device=dev),
                      chacha.expand_mask_for(prg, seed, d, m))
            print(f"  expand {prg} m={m}: d in {list(dims)} equal to plain "
                  f"and host spec; {replayed} of {len(dims)} seeds replayed")
            # the combine's replay (and the fold at 2^61 - 1's width)
            seeds = seed_words(9)
            cd.chacha_kernel.replayed = 0
            want = np.zeros(1000, dtype=object)
            for sd in seeds:
                want = (want + chacha.expand_mask_for(prg, sd, 1000, m)) % m
            equal(f"combine_masks {prg} m={m} S=9 d=1000 vs host spec",
                  cd.combine_masks(seeds, 1000, m, prg=prg, device=dev),
                  want.astype(np.int64))
            print(f"  combine_masks {prg} m={m} S=9 d=1000: equal to host "
                  f"spec, {cd.chacha_kernel.replayed} seeds replayed")
    # windows of the V1 stream at nonzero block counters (one wraps 2^32)
    seeds = seed_words(5)
    sw = cd._seed_matrix(seeds, dev)
    for c0 in (1, 12_345, (1 << 32) - 2):
        got = cd.stream_residues_at(sw, c0, dimension=d_big, modulus=p)
        equal(f"window counter0={c0} vs plain", got,
              cd.expand_plain(sw, c0, d_big, p, chacha.CHACHA_PRG_V1)[0])
        equal(f"window counter0={c0} vs host spec", got[0],
              _host_window(seeds[0], c0, d_big, p))
    print(f"  windows S=5 x d={d_big} at counter0 1, 12345, 2^32 - 2: "
          "equal to plain and host spec")
    # the keystream of one key, the blocks of a window that wraps
    nblocks = -(-d_big // 8)
    for c0 in (0, (1 << 32) - 2):
        equal(f"blocks counter0={c0} x {nblocks}",
              cd.chacha_block_words(sw[0], c0, nblocks=nblocks),
              cd.block_words_plain(sw[:1], c0, nblocks)[0])
    print(f"  blocks of one key x {nblocks} at counter0 0, 2^32 - 2: equal "
          "to plain")
    # the recipient's combine at the flagship width
    seeds = seed_words(s_combine)
    sw = cd._seed_matrix(seeds, dev)
    host_combine = (native.chacha_combine_masks if native.available()
                    else None)
    for prg in (chacha.CHACHA_PRG_V1, chacha.CHACHA_PRG_RAND03):
        got = cd.combine_masks(seeds, d_big, p, prg=prg, device=dev)
        equal(f"combine {prg} S={s_combine} d={d_big} vs plain", got,
              cd.combine_plain(sw, d_big, p, prg)[0])
        if host_combine is not None:
            equal(f"combine {prg} S={s_combine} d={d_big} vs native host",
                  got, host_combine(np.asarray(seeds, dtype=np.int64), d_big,
                                    p, prg=prg))
    print(f"  combine_masks S={s_combine} x d={d_big}, both PRGs: equal to "
          f"plain{' and native host' if host_combine else ''}")
    # the main path's: the mask op at the streamed round's tile, and the
    # expand at the same window
    t_mask = time.perf_counter()
    mask_plain_ms = _k3_mask_holds(dev, p, equal, mask_seeds, mask_dims,
                                   timed=(*tile, 12_345))
    _k3_derived_holds(dev, p, equal, shapes=derived_shapes)
    # the derived mode at the streamed tile, ids across 2^32, into an
    # accumulator: the streamed step's call
    _k3_window(f"streamed tile [{tile[0]}, {tile[1]}]", dev, 15,
               (1 << 32) - tile[0] // 2, tile[0], 12_345, tile[1], p,
               out_dtype=torch.int32, acc=True)
    gen = torch.Generator(device=dev)
    tile_words = torch.randint(0, 1 << 32, (tile[0], 8), dtype=torch.int64,
                               device=dev, generator=gen.manual_seed(13))
    t0 = time.perf_counter()
    want = cd.expand_plain(tile_words, 12_345, tile[1], p,
                           chacha.CHACHA_PRG_V1)[0]
    _sync(dev)
    expand_plain_ms = (time.perf_counter() - t0) * 1e3
    equal(f"window [{tile[0]}, {tile[1]}] counter0=12345 vs plain",
          cd.stream_residues_at(tile_words, 12_345, dimension=tile[1],
                                modulus=p), want)
    del want
    _empty_cache(dev)
    print(f"  window [{tile[0]}, {tile[1]}] at counter0 12345: equal to "
          f"plain; the mask holds and this window in "
          f"{time.perf_counter() - t_mask:.1f} s")
    launches = dict(k3.op_launches)
    print(f"  K3 launches in phase 12: {launches}")

    prg = chacha.CHACHA_PRG_V1
    ops = {}

    def record(op, ms, plain_ms, bound, shape, **kw):
        ops[op] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                   "bound_by": bound[1],
                   "share": None if not ms else bound[0] / ms,
                   "shape": shape, "ptxas": ptxas.get(op),
                   "seed_loop": loops.get(op), **kw}
        print(f"K3 {op} at {shape}: "
              + ("not timed (no card)" if ms is None else
                 f"{ms:.4f} ms median of 20 (CUDA events), "
                 f"{bound[0] / ms:.1%} of its bound")
              + "; plain " + ("not timed" if plain_ms is None
                              else f"{plain_ms:.3f} ms")
              + f"; bound {bound[0]:.4f} ms ({bound[2]})")

    def timed(fn, reps=20, warmup=2):
        return median_ms(fn, dev, reps=reps, warmup=warmup) if on_card \
            else None

    record("blocks", timed(lambda: cd.chacha_block_words(
        sw[0], 0, nblocks=nblocks)),
        median_ms(lambda: cd.block_words_plain(sw[:1], 0, nblocks), dev,
                  reps=3, warmup=1),
        k3_bound(1, 8 * nblocks, "blocks"), f"[{nblocks}] blocks")
    record("expand", timed(lambda: cd.stream_residues_at(
        tile_words, 12_345, dimension=tile[1], modulus=p)), expand_plain_ms,
        k3_bound(tile[0], tile[1], "expand"), f"[{tile[0]}, {tile[1]}]")
    x = torch.randint(0, p, (tile[0], tile[1]), dtype=torch.int64,
                      device=dev, generator=gen.manual_seed(14))
    for dtype, size in ((torch.int32, 4), (torch.int64, 8)):
        record("mask" if size == 4 else "mask_int64", timed(
            lambda: cd.mask_residues_at(tile_words, 12_345, x, modulus=p,
                                        out_dtype=dtype)),
            mask_plain_ms if size == 4 else None,
            k3_bound(tile[0], tile[1], "mask", size),
            f"[{tile[0]}, {tile[1]}] {dtype}")
    # the derived mode into an accumulator, as the streamed step runs it
    # (the plain version: chacha_seed_words, mask_plain, the in-place add)
    acc = torch.zeros(tile[1], dtype=torch.int64, device=dev)
    derived_plain_ms = median_ms(lambda: cd.mask_plain(
        _seed_words(15, torch.arange(tile[0], device=dev), 128), 12_345, x,
        p, torch.int32, acc), dev, reps=1, warmup=0)
    record("mask_derived", timed(lambda: cd.mask_residues_derived(
        15, 0, 128, 12_345, x, modulus=p, out_dtype=torch.int32,
        acc_mask=acc)), derived_plain_ms,
        k3_bound(tile[0], tile[1], "mask", 4, derived=True,
                 accumulate=True),
        f"[{tile[0]}, {tile[1]}] int32, derived keys, accumulate",
        ptxas=ptxas.get("mask"), seed_loop=loops.get("mask"))
    del x, tile_words, acc
    _empty_cache(dev)
    plain_ms = median_ms(lambda: cd.combine_plain(sw, d_big, p, prg), dev,
                         reps=3, warmup=1)
    big = cd._seed_matrix(seed_words(s_big), dev)
    big_ms = timed(lambda: cd.chacha_kernel(
        "combine", big, dimension=d_big, modulus=p, prg=prg), reps=5,
        warmup=1)
    del big
    host_ms = None
    if host_combine is not None:
        stacked = np.asarray(seeds, dtype=np.int64)
        t0 = time.perf_counter()
        host_combine(stacked, d_big, p, prg=prg)
        host_ms = (time.perf_counter() - t0) * 1e3
    big_bound = k3_bound(s_big, d_big, "combine")
    record("combine", timed(lambda: cd.chacha_kernel(
        "combine", sw, dimension=d_big, modulus=p, prg=prg)), plain_ms,
        k3_bound(s_combine, d_big, "combine"), f"S={s_combine} x d={d_big}",
        **{f"ms_s{s_big}": big_ms, f"bound_ms_s{s_big}": big_bound[0],
           "host_ms": host_ms})
    print(f"K3 combine at S={s_big} x d={d_big}: "
          f"{big_ms if big_ms is None else round(big_ms, 4)} ms median of 5;"
          f" bound {big_bound[0]:.4f} ms ({big_bound[2]}); native host "
          f"combine at S={s_combine}: "
          f"{'not available' if host_ms is None else f'{host_ms:.3f} ms'}")
    return {"ops": ops, "max_abs_err": max_err, "check_launches": launches}


def chacha_round(dev, P, D, seed=0):
    """Phase 14: ``single_chip_round`` with ChaCha masking on the flagship
    scheme, exact against the column sum mod p; K3 must have launched.
    Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import ChaChaMasking

    scheme, _, p = _flagship()
    inputs = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 20, size=(P, D), dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    fn = single_chip_round(scheme, ChaChaMasking(p, D, 128), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k3 = _k3_reset()
    seed0 = _count_seed_words()
    out = fn(inputs, gen)
    launches = dict(k3.op_launches)
    _check(out.dtype == torch.int64 and out.shape == (D,),
           f"ChaCha round: output {out.dtype}{tuple(out.shape)}")
    _check(torch.equal(out, expect), "ChaCha round: != column sum mod p")
    on_card = dev.type == "cuda"
    _check(not on_card or (launches["mask"] == 1 and
                           launches["expand"] == 0 and
                           k3.derived_launches == 1),
           f"ChaCha round: K3 launches {launches} ({k3.derived_launches} "
           "derived), want one mask op deriving its keys")
    # the mask op the round ran: its round seed is the generator's first
    # draw, its participants 0..P-1, its counter 0, its x the inputs
    from sda_tpu_torch.mesh import simpod

    round_seed = simpod._round_seed(
        torch.Generator(device=dev).manual_seed(seed))
    err = _k3_window("ChaCha round", dev, round_seed, 0, P, 0, D, p,
                     x=inputs.to(torch.int64))
    ms = _median_ms(lambda: fn(inputs, gen), reps=5, warmup=1) \
        if on_card else None
    seed_calls = _count_seed_words() - seed0
    _check(not on_card or seed_calls == 0, f"ChaCha round: the seed words "
           f"derived on the host {seed_calls} times")
    return {"stage": "chacha_round", "participants": P, "dim": D,
            "seed_word_calls": seed_calls,
            "exact": True, "k3_launches": launches,
            "k3_window_max_abs_err": err, "round_ms": ms,
            "elements_per_s": None if ms is None else P * D / (ms / 1e3)}


def _k6_reset():
    from sda_tpu_torch.fields import blockgen

    k6 = blockgen.coordinate_block
    k6.launches = 0
    return k6


def _k6_hold(case, dev, p0, rows, d0, cols, seed, bound):
    """K6's block [rows, cols] at (p0, d0) of the provider of ``seed`` and
    ``bound`` against its plain version on ``dev``, ``torch.equal``.
    Returns the max |error| (0 when equal)."""
    import torch

    from sda_tpu_torch.fields import blockgen

    coords = (p0, p0 + rows, d0, d0 + cols, seed, bound, dev)
    got = blockgen.coordinate_block(*coords)
    want = blockgen.block_plain(*coords)
    _check(got.dtype == want.dtype == torch.int64
           and got.shape == want.shape == (rows, cols)
           and got.is_contiguous(),
           f"{case}: K6 {got.dtype}{tuple(got.shape)} vs plain "
           f"{want.dtype}{tuple(want.shape)}")
    err = 0 if torch.equal(got, want) else int((got - want).abs().max())
    _check(err == 0, f"{case}: K6 [{rows}, {cols}] at ({p0}, {d0}), bound "
           f"{bound} != plain (max |err| {err})")
    print(f"  {case}: K6 [{rows}, {cols}] at ({p0}, {d0}), bound {bound}: "
          "equal to plain")
    del got, want
    if rows * cols > 1 << 24:
        _empty_cache(dev)
    return err


def blockgen_kernels(dev, p, lib_path, ptxas_log, cuobjdump,
                     blocks=K6_BLOCKS, bounds=K6_BOUNDS, seed=K6_SEED,
                     host_sample=K6_HOST_SAMPLE,
                     time_shape=(STREAM_CHUNK, D_TILE), reps=20):
    """Phase 14b: K6, the device block provider's kernel
    (``csrc/blockgen.cu``): its ptxas line (a spill fails) and its row
    loop's SASS by pipe; K6 held to its plain version at ``blocks`` x (p,
    *``bounds``) and to the host provider on ``host_sample``; its time at
    ``time_shape`` (median of ``reps`` CUDA-event times) beside its bound
    and its plain version's. The SASS is skipped without ``lib_path``
    (off the card). Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch.benchmarks.bounds import blockgen_bound
    from sda_tpu_torch.fields import blockgen
    from sda_tpu_torch.mesh import synthetic_block_provider32
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    rec = {"stage": "blockgen", "ptxas": None, "row_loop": None,
           "bound_ms_row_loop": None}
    if lib_path is not None:
        ptx = next((v for key, v in sass.ptxas_info(ptxas_log).items()
                    if K6_KERNEL in key), None)
        _check(ptx is not None, f"{K6_KERNEL}: no ptxas line")
        _check(not sass.spills(ptx), f"{K6_KERNEL} spills: {'; '.join(ptx)}")
        rec["ptxas"] = ptx
        print(f"  K6 ({K6_KERNEL}): {'; '.join(ptx)}")
        try:
            lines = sass.loop_instructions(lib_path, cuobjdump, K6_KERNEL)
        except (LookupError, ValueError) as exc:
            print(f"  K6 row loop: not found ({exc})")
            lines = None
        if lines is not None:
            mix = collections.Counter(op for op, _ in lines)
            rec["row_loop"] = {"instructions": sum(mix.values()),
                               "pipes": sass.pipe_mix(lines),
                               "opcodes": dict(mix.most_common(16))}
            print(f"  K6 row loop (8 values and the code of a row's two "
                  f"lone ones): {rec['row_loop']['instructions']} "
                  f"instructions, pipes {rec['row_loop']['pipes']}: "
                  + ", ".join(f"{o} {c}" for o, c in mix.most_common(12)))
            wide = sum(c for o, c in mix.items()
                       if o.startswith("STG") and ".128" in o)
            _check(wide >= 4, f"K6's row loop has {wide} 16-byte stores, "
                   "want one a pair (4)")
    err = 0
    t0 = time.perf_counter()
    for p0, rows, d0, cols in blocks:
        for bound in (p, *bounds):
            err = max(err, _k6_hold("K6 hold", dev, p0, rows, d0, cols,
                                    seed, bound))
    p0, rows, d0, cols = host_sample
    got = blockgen.coordinate_block(p0, p0 + rows, d0, d0 + cols, seed,
                                    1 << 20, dev).cpu().numpy()
    host = synthetic_block_provider32(p, seed=seed, max_value=1 << 20)(
        p0, p0 + rows, d0, d0 + cols)
    _check(np.array_equal(got, host), "K6 != the host provider")
    print(f"  K6 [{rows}, {cols}] at ({p0}, {d0}) == the host provider's "
          f"block; {len(blocks) * (1 + len(bounds))} plain holds in "
          f"{time.perf_counter() - t0:.1f} s")
    rows, cols = time_shape
    coords = (0, rows, 0, cols, seed, 1 << 20, dev)
    ms = median_ms(lambda: blockgen.coordinate_block(*coords), dev,
                   reps=reps)
    plain_ms = median_ms(lambda: blockgen.block_plain(*coords), dev, reps=3,
                         warmup=1)
    bound_ms, bound_by, detail = blockgen_bound(rows, cols)
    rec.update({"holds": len(blocks) * (1 + len(bounds)) + 1,
                "max_abs_err": err, "shape": [rows, cols], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share": bound_ms / ms})
    if rec["row_loop"] is not None:
        pipes = rec["row_loop"]["pipes"]
        rec["bound_ms_row_loop"] = blockgen_bound(
            rows, cols, pipes["alu"] / 8, pipes["fma"] / 8)[0]
    print(f"  K6 at [{rows}, {cols}]: {ms:.4f} ms median of {reps} (CUDA "
          f"events), {rows * cols * 8 / (ms / 1e3) / 1e9:.1f} GB/s written; "
          f"bound {bound_ms:.4f} ms ({detail}; {bound_ms / ms:.0%}); the row "
          f"loop's own mix gives {rec['bound_ms_row_loop']} ms; plain "
          f"{plain_ms:.3f} ms median of 3")
    _empty_cache(dev)
    return rec


def _ptxas_lines(ptxas_log, kernels, label):
    """Each of ``kernels``' ptxas lines (a spill fails), printed; None off
    the card (no log)."""
    from sda_tpu_torch.utils import sass

    if ptxas_log is None:
        return None
    info = sass.ptxas_info(ptxas_log)
    lines = {}
    for kernel in kernels:
        ptx = next((v for key, v in info.items() if kernel in key), None)
        _check(ptx is not None, f"{kernel}: no ptxas line")
        _check(not sass.spills(ptx), f"{kernel} spills: {'; '.join(ptx)}")
        lines[kernel] = ptx
        print(f"  {label} ({kernel}): {'; '.join(ptx)}")
    return lines


def _k7_k8_reset():
    from sda_tpu_torch.fields.residues import residues_int32
    from sda_tpu_torch.fields.reveal import reveal

    reveal.launches = residues_int32.launches = 0
    return reveal, residues_int32


def _equal(case, got, want):
    """``torch.equal`` of a kernel's output and its plain version's, the
    same dtype and shape; returns the max |error| (0)."""
    import torch

    _check(got.dtype == want.dtype and got.shape == want.shape,
           f"{case}: {got.dtype}{tuple(got.shape)} vs plain "
           f"{want.dtype}{tuple(want.shape)}")
    err = 0 if torch.equal(got, want) else int(
        (got.to(torch.int64) - want.to(torch.int64)).abs().max())
    _check(err == 0, f"{case}: kernel != plain version (max |err| {err})")
    return err


def _raw_block(rng, dtype, rows, cols, offset=None):
    """A [rows, cols] block of raw values of ``dtype`` ("int64" with
    negatives and the +-2^63 edges, "int32", "uint32") on the host, as a
    strided view at column ``offset`` of a wider block when given."""
    import numpy as np
    import torch

    width = cols + (0 if offset is None else offset + 3)
    if dtype == "int64":
        x = rng.integers(-(1 << 63), (1 << 63) - 1, size=(rows, width),
                         dtype=np.int64, endpoint=True)
        edges = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 62), 1 << 62]
        x.flat[:len(edges)] = edges[:x.size]
    elif dtype == "int32":
        x = rng.integers(-(1 << 31), (1 << 31) - 1, size=(rows, width),
                         dtype=np.int32, endpoint=True)
        x.flat[:3] = [-(1 << 31), (1 << 31) - 1, -1][:x.size]
    else:
        x = rng.integers(0, (1 << 32) - 1, size=(rows, width),
                         dtype=np.uint32, endpoint=True)
    t = torch.from_numpy(x)
    return t if offset is None else t[:, offset:offset + cols]


def reveal_kernels(dev, p, reveal_ptxas, residues_ptxas, cases=K7_CASES,
                   timed=K7_TIMED, blocks=K8_BLOCKS, mask_shapes=(
                       (5, 1000), (STREAM_CHUNK, D_TILE)), reps=20):
    """Phase 14c: K7, the reveal (``csrc/reveal.cu``), and K8, the residue
    pass (``csrc/residues.cu``): their ptxas lines (a spill fails); K7 held
    to its plain version (``reveal_plain``, today's eager chain) with
    ``torch.equal`` at ``cases``, each unmasked and with a batched and a
    flat mask, and timed at ``timed`` beside ``bounds.reveal_bound``; K8
    held at ``blocks`` (negative values and the +-2^63 edges, int32 and
    uint32, strided views) and timed at the last beside its bound and the
    library call ``torch.remainder(x, p).to(torch.int32)``; K3's mask op
    on raw int64 blocks held to ``mask_plain`` of their residues at
    ``mask_shapes`` (the flagship p, int32 out; 433 and 2^61 - 1, int64
    out). Off the card the ptxas lines are skipped. Returns the phase's
    JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.benchmarks.bounds import (k3_bound, residues_bound,
                                                 reveal_bound)
    from sda_tpu_torch.fields import chacha_device, numtheory
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.fields.residues import (residues_int32,
                                               residues_int32_plain)
    from sda_tpu_torch.fields.reveal import reveal, reveal_plain
    from sda_tpu_torch.utils.benchtime import median_ms

    rec = {"stage": "reveal_kernels",
           "ptxas": {"K7": _ptxas_lines(reveal_ptxas, K7_KERNELS, "K7"),
                     "K8": _ptxas_lines(residues_ptxas, K8_KERNELS, "K8")}}
    rng = np.random.default_rng(14)
    _k7_k8_reset()
    t0 = time.perf_counter()
    holds = k7_err = 0
    for case, sharing, k, n, survivors, B, d in cases:
        if sharing is None:
            sp = SolinasPrime.try_from(p)
            L = rng.integers(0, p, size=(k, n + 1))
        else:
            scheme = _sim_scheme(k, n, sharing)
            _check(scheme.secret_count == k and scheme.share_count == n,
                   f"{case}: sda-sim's scheme is {scheme}")
            sp = SolinasPrime.try_from(scheme.prime_modulus)
            L = numtheory.reconstruct_matrix_for(
                scheme, tuple(range(n)) if survivors is None else survivors)
        rows = torch.from_numpy(rng.integers(0, sp.p, size=(n, B))).to(dev)
        masks = {"unmasked": None,
                 "batched": torch.from_numpy(
                     rng.integers(0, sp.p, size=(k, B))).to(dev),
                 "flat": torch.from_numpy(
                     rng.integers(0, sp.p, size=d)).to(dev)}
        for layout, mask in masks.items():
            args = (rows, L, sp)
            kw = dict(dimension=d, mask=mask, rows_index=survivors)
            k7_err = max(k7_err, _equal(f"K7 {case} {layout}",
                                        reveal(*args, **kw),
                                        reveal_plain(*args, **kw)))
            holds += 1
        print(f"  K7 {case} (k={k}, r={L.shape[1] - 1}, B={B}, d={d}): "
              "unmasked, batched and flat masks equal to plain")
        del rows, masks
    rec.update({"k7_holds": holds, "k7_holds_s": time.perf_counter() - t0})
    # K7's times at the paths' shapes, beside the bound and the plain chain
    sp = SolinasPrime.try_from(p)
    scheme, _, _ = _flagship()
    L = numtheory.reconstruct_matrix_for(scheme, tuple(range(8)))
    rec["k7_timed"] = []
    for case, r, B, k, d, layout in timed:
        rows = torch.from_numpy(rng.integers(0, p, size=(r, B))).to(dev)
        mask = torch.from_numpy(rng.integers(
            0, p, size=(k, B) if layout == "batched" else d)).to(dev)
        kw = dict(dimension=d, mask=mask)
        k7_err = max(k7_err, _equal(f"K7 {case}", reveal(rows, L, sp, **kw),
                                    reveal_plain(rows, L, sp, **kw)))
        ms = median_ms(lambda: reveal(rows, L, sp, **kw), dev, reps=reps)
        plain_ms = median_ms(lambda: reveal_plain(rows, L, sp, **kw), dev,
                             reps=3, warmup=1)
        bound_ms, bound_by, detail = reveal_bound(r, B, k, d, layout)
        rec["k7_timed"].append({
            "case": case, "r": r, "B": B, "k": k, "d": d, "mask": layout,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / ms})
        print(f"  K7 {case} [{r}, {B}] -> d={d}, {layout} mask: {ms:.4f} ms "
              f"median of {reps} (CUDA events; inputs of "
              f"{(rows.numel() + mask.numel()) * 8} bytes against a 50 MB "
              f"L2); bound "
              f"{bound_ms:.4f} ms ({detail}; {bound_ms / ms:.0%}); plain "
              f"{plain_ms:.3f} ms median of 3")
        del rows, mask
        _empty_cache(dev)
    # K8 at raw blocks of each dtype, then timed at the streamed tile
    t1 = time.perf_counter()
    k8_err = 0
    for dtype, rows_n, cols, offset in blocks:
        x = _raw_block(rng, dtype, rows_n, cols, offset).to(dev)
        got = residues_int32(x, sp)
        k8_err = max(k8_err, _equal(f"K8 {dtype} [{rows_n}, {cols}]", got,
                                    residues_int32_plain(x, sp)))
        print(f"  K8 {dtype} [{rows_n}, {cols}]"
              + ("" if offset is None else f" (a view at column {offset})")
              + ": equal to plain")
        del got
    rec["k8_holds"] = len(blocks)
    rec["k8_holds_s"] = time.perf_counter() - t1
    dtype, rows_n, cols, _ = blocks[-1]
    n = rows_n * cols
    ms = median_ms(lambda: residues_int32(x, sp), dev, reps=reps)
    plain_ms = median_ms(lambda: residues_int32_plain(x, sp), dev, reps=3,
                         warmup=1)
    library_ms = median_ms(lambda: torch.remainder(x, p).to(torch.int32),
                           dev, reps=5, warmup=1)
    bound_ms, bound_by, detail = residues_bound(n, x.element_size())
    rec["k8"] = {"dtype": dtype, "shape": [rows_n, cols], "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "share": bound_ms / ms,
                 "no_slower_than_library": ms <= library_ms}
    print(f"  K8 at {dtype} [{rows_n}, {cols}]: {ms:.4f} ms median of {reps} "
          f"(CUDA events), {n * 12 / (ms / 1e3) / 1e9:.1f} GB/s; bound "
          f"{bound_ms:.4f} ms ({detail}; {bound_ms / ms:.0%}); plain "
          f"{plain_ms:.3f} ms, library torch.remainder(x, p).to(int32) "
          f"{library_ms:.3f} ms median of 5")
    # K3's mask op on raw blocks: the residue pass folded into the kernel
    t2 = time.perf_counter()
    mask_err = 0
    for S, d in mask_shapes:
        raw = x if (S, d) == (rows_n, cols) else _raw_block(
            rng, "int64", S, d).to(dev)
        seeds = torch.from_numpy(rng.integers(0, 1 << 32, size=(S, 8))).to(
            dev)
        for m, out_dtype in ((p, torch.int32), (433, torch.int64),
                             ((1 << 61) - 1, torch.int64)):
            if m != p and S * d > 1 << 24:
                continue
            got = chacha_device.chacha_kernel(
                "mask", seeds, counter0=12_345, modulus=m, x=raw,
                out_dtype=out_dtype)
            want = chacha_device.mask_plain(
                seeds, 12_345, torch.remainder(raw, m), m, out_dtype)
            for g, w in zip(got, want):
                mask_err = max(mask_err, _equal(
                    f"K3 mask on raw [{S}, {d}] mod {m}", g, w))
            del got, want
            print(f"  K3 mask op on a raw int64 [{S}, {d}] mod {m} "
                  f"({out_dtype}): equal to mask_plain of its residues")
        if (S, d) == (rows_n, cols):
            ms3 = median_ms(lambda: chacha_device.chacha_kernel(
                "mask", seeds, counter0=12_345, modulus=p, x=raw,
                out_dtype=torch.int32), dev, reps=5, warmup=1)
            b3 = k3_bound(S, d, "mask", 4)
            rec["k3_raw_ms"] = {"shape": [S, d], "ms": ms3,
                                "bound_ms": b3[0], "bound_by": b3[1]}
            print(f"  K3 mask op on the raw tile [{S}, {d}] (int32 out): "
                  f"{ms3:.4f} ms median of 5; bound {b3[0]:.4f} ms "
                  f"({b3[2]}; {b3[0] / ms3:.0%})")
        del raw, seeds
    rec.update({"k3_raw_max_abs_err": mask_err,
                "k3_raw_s": time.perf_counter() - t2,
                "k7_max_abs_err": k7_err, "k8_max_abs_err": k8_err})
    del x
    _empty_cache(dev)
    return rec


def streamed_round(dev, P, D, chunk, fold_rows=FOLD_ROWS,
                   fold_dim=D_CHACHA, fold_bundles=FOLD_BUNDLES):
    """Phase 15: ``StreamingAggregator(use_pallas=True)`` with ChaCha
    masking over the device block provider, exact against the plain column
    sum recomputed on the device chunk by chunk from the same provider
    (K6), with K6 held to its plain version at the round's first, last and
    ragged tiles; K1, K3 and K6 must have launched on every tile. Then
    ``DeviceTileCombiner`` folds ``fold_rows`` rows in ``fold_bundles``
    bundles, exact against ``mod_combine``. Returns the phase's JSON
    record."""
    import numpy as np
    import torch

    from sda_tpu_torch import utils
    from sda_tpu_torch.crypto.sharing import mod_combine
    from sda_tpu_torch.fields import fused_round
    from sda_tpu_torch.mesh import (DeviceTileCombiner, StreamingAggregator,
                                    synthetic_device_block_provider32)
    from sda_tpu_torch.protocol import ChaChaMasking

    scheme, _, p = _flagship()
    round_seed = 15
    prov = synthetic_device_block_provider32(p, seed=15, max_value=1 << 20,
                                             device=dev)
    agg = StreamingAggregator(scheme, ChaChaMasking(p, D, 128),
                              participants_chunk=chunk, use_pallas=True,
                              device=dev)
    K1 = fused_round.fused_mask_share_combine
    k3, k6 = _k3_reset(), _k6_reset()
    k7, k8 = _k7_k8_reset()
    K1.launches = 0
    K1.instance_launches.update(dict.fromkeys(fused_round.INSTANCES, 0))
    utils.reset_phase_report()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    seed_calls0 = _count_seed_words()
    t0 = time.perf_counter()
    out = agg.aggregate_blocks(prov, P, D, seed=round_seed)
    wall = time.perf_counter() - t0
    seed_calls = _count_seed_words() - seed_calls0
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else None
    phases = _phases(utils)
    k1_launches, k3_launches = dict(K1.instance_launches), dict(k3.op_launches)
    k3_derived = k3.derived_launches
    k6_round, k7_round, k8_round = k6.launches, k7.launches, k8.launches
    dc = agg.dim_chunk
    tiles = -(-P // chunk) * -(-D // dc)
    dim_tiles = -(-D // dc)
    _check(out.dtype == np.int64 and out.shape == (D,),
           f"streamed round: output {out.dtype}{out.shape}")
    # the oracle reads the provider through K6 as the round did; K6 is held
    # to its plain version at the round's own tiles below
    for d0 in range(0, D, dc):
        d1 = min(d0 + dc, D)
        want = torch.zeros(d1 - d0, dtype=torch.int64, device=dev)
        for p0 in range(0, P, chunk):
            want += prov(p0, min(p0 + chunk, P), d0, d1).sum(0)
        _check(torch.equal(torch.from_numpy(out[d0:d1]).to(dev), want % p),
               f"streamed round: dims [{d0}, {d1}) != column sum mod p")
    k6_oracle = k6.launches - k6_round
    d_starts = range(0, D, dc)
    last_p0 = (P - 1) // chunk * chunk
    k6_err = 0
    for case, p0, d0 in (("first", 0, 0),
                         ("last full-width", last_p0,
                          d_starts[max(0, len(d_starts) - 2)]),
                         ("ragged last", last_p0, d_starts[-1])):
        k6_err = max(k6_err, _k6_hold(
            f"streamed round, {case} tile", dev, p0, min(chunk, P - p0), d0,
            min(d0 + dc, D) - d0, 15, 1 << 20))
    if on_card:
        _check(k6_round == tiles, f"streamed round: K6 launched {k6_round} "
               f"times, want {tiles} (one a tile)")
        unmasked = k1_launches["columns_unmasked"]
        _check(K1.launches == tiles and unmasked == tiles,
               f"streamed round: K1 instances {k1_launches}, want {tiles} "
               "on columns_unmasked")
        _check(k3_launches["mask"] == tiles and k3_launches["expand"] == 0
               and k3_derived == tiles,
               f"streamed round: K3 launches {k3_launches} "
               f"({k3_derived} derived), want {tiles} mask ops "
               "deriving their keys and no expand")
        _check(seed_calls == 0, f"streamed round: the seed words derived "
               f"on the host {seed_calls} times")
        # the mask ops read the raw blocks (phase 17's trace of this round
        # holds no residue pass); one K7 finale a dim tile; no K8 on the
        # ChaCha lane
        _check(k7_round == dim_tiles and k8_round == 0,
               f"streamed round: K7 launched {k7_round} times, K8 "
               f"{k8_round}; want {dim_tiles} and 0")
    print(f"streamed round: P={P} x d={D}, chunks {chunk} x {dc}, {tiles} "
          f"tiles: exact, wall {wall:.3f} s, {P * D / wall:.4e} "
          f"shared-elements/s; device peak "
          f"{'not measured' if peak is None else f'{peak} bytes'} above "
          f"the phase's start; K1 {k1_launches}, K3 {k3_launches} (on raw "
          f"blocks), K6 {k6_round} (the oracle's {k6_oracle}), K7 "
          f"{k7_round}, K8 {k8_round}")
    # K3's mask op at the round's own tiles, on the provider's rows there
    # (zero-padded to the ChaCha grain, as the round pads them): the first
    # participant chunk of dim tile 0, the last chunk of dim tile 1, and
    # the ragged dim tail
    err = 0
    for p0, d0 in sorted({(0, d_starts[0]), (0, d_starts[-1]),
                          (last_p0, d_starts[min(1, len(d_starts) - 1)])}):
        d1, rows = min(d0 + dc, D), min(chunk, P - p0)
        width = -(-(d1 - d0) // agg._grain) * agg._grain
        x = torch.zeros((rows, width), dtype=torch.int64, device=dev)
        x[:, :d1 - d0] = prov(p0, p0 + rows, d0, d1)  # raw, as the round
        err = max(err, _k3_window("streamed round", dev, round_seed, p0,
                                  rows, d0 // 8, width, p, x=x,
                                  out_dtype=torch.int32, acc=True))
        del x
        _empty_cache(dev)
    # the device-tile clerk fold
    rng = np.random.default_rng(15)
    rows = rng.integers(0, p, size=(fold_rows, fold_dim))
    comb = DeviceTileCombiner(p, device=dev)
    t1 = time.perf_counter()
    for bundle in np.array_split(rows, fold_bundles):
        comb.fold(bundle)
    folded = comb.result()
    fold_s = time.perf_counter() - t1
    _check(np.array_equal(folded, mod_combine(list(rows), p,
                                              torch.device("cpu"))),
           "DeviceTileCombiner != mod_combine")
    print(f"DeviceTileCombiner: {fold_rows} rows x d={fold_dim} in "
          f"{fold_bundles} bundles (tile {comb._dim_tile}) == mod_combine, "
          f"{fold_s:.3f} s")
    return {"stage": "streamed_round", "participants": P, "dim": D,
            "participants_chunk": chunk, "dim_chunk": dc, "tiles": tiles,
            "exact": True, "wall_s": wall, "elements_per_s": P * D / wall,
            "device_peak_bytes": peak,
            "out_sha256": hashlib.sha256(out.tobytes()).hexdigest(),
            "phases_s": phases,
            "k1_launches": k1_launches, "k3_launches": k3_launches,
            "k3_derived_launches": k3_derived,
            "seed_word_calls": seed_calls,
            "k3_window_max_abs_err": err, "k6_launches": k6_round,
            "k6_launches_oracle": k6_oracle, "k6_max_abs_err": k6_err,
            "k7_launches": k7_round, "k8_launches": k8_round,
            "fold": {"rows": fold_rows, "dim": fold_dim,
                     "bundles": fold_bundles, "tile": comb._dim_tile,
                     "exact": True, "wall_s": fold_s}}


def bench_phase(dev, k1_ms, P=P_MAIN, D=D_MAIN, seconds=BENCH_SECONDS,
                extra=()):
    """Phase 17: the port's bench in-process at P x D (``extra``: more
    bench flags). Every lane exact, the roofline utilization in (0, 1.05],
    and on a card K1's launches equal to its lanes' calls (one a
    monolithic round, a tile's a tiled round, a step's a streamed one).
    K1's device time in the bench's trace is printed beside ``k1_ms``
    (``median_ms``, phase 5). The regression gate runs over the repo's
    ``BENCH_r*.json`` with the bench's line as the newest record: it must
    exit 0 and find no comparable history. The instrumented round is
    timed against the bare one (cost capture off and on, behind a plain
    Python frame, and bare with the garbage collector off), in turns. Returns
    the phase's JSON record."""
    import torch

    from sda_tpu_torch.benchmarks import bench
    from sda_tpu_torch.cli import bench as sda_bench
    from sda_tpu_torch.fields import fused_round
    from sda_tpu_torch.obs import devprof

    K1 = fused_round.fused_mask_share_combine
    K1.launches = 0
    t0 = time.perf_counter()
    argv = ["--participants", str(P), "--dim", str(D), "--seconds",
            str(seconds), *extra]
    if dev.type == "cpu":
        argv += ["--device", "cpu"]
    line = bench.run(bench.build_parser().parse_args(argv))
    bench_s = time.perf_counter() - t0
    launches = K1.launches
    print(json.dumps(line), flush=True)
    tiled, streamed = line["dim_tiled"], line["streamed"]
    _check(line["exact"] and tiled["exact"] and streamed["exact"],
           "bench: a lane is not exact")
    util = line["roofline"]["utilization"]
    _check(0 < util <= 1.05, f"bench: roofline utilization {util} "
           "outside (0, 1.05]: a counting bug")
    want = {"monolithic": line["round_calls"],
            "tiled": tiled["round_calls"] * tiled["tiles"],
            "streamed": streamed["round_calls"] * streamed["steps"]}
    if dev.type == "cuda":
        _check(line["k1_launches"] == want and launches == sum(want.values()),
               f"bench: K1 launches {line['k1_launches']} (all {launches}),"
               f" want {want}")
    prof = line["device_profile"]
    trace_ms = prof["k1_median_ms"]
    print(f"bench: {line['value']:.4e} shared-elements/s, round median "
          f"{line['round_seconds_median'] * 1e3:.4f} ms of "
          f"{line['rounds']} (min {line['round_seconds_min'] * 1e3:.4f}, "
          f"max {line['round_seconds_max'] * 1e3:.4f}), marginal "
          f"{line['round_seconds_marginal'] * 1e3:.4f} ms; tiled "
          f"{tiled['round_seconds_median'] * 1e3:.4f} ms, streamed "
          f"{streamed['round_seconds_median'] * 1e3:.4f} ms; busy share "
          f"{prof['busy_share']}; utilization {util}; K1 launches {launches}"
          f" ({want}); {bench_s:.1f} s")
    print(f"K1 in the bench's trace: {trace_ms} ms median of "
          f"{prof['k1_count']} ({prof['k1_kernel']}); median_ms (phase 5): "
          f"{k1_ms} ms; ratio "
          f"{None if not (trace_ms and k1_ms) else trace_ms / k1_ms}")

    # the gate: the bench's line as the newest record of the repo's
    # trajectory, in the committed records' wrapper shape
    paths = sorted(str(f) for f in
                   Path(__file__).resolve().parent.glob("BENCH_r*.json"))
    newest_n = max(json.loads(Path(f).read_text()).get("n", 0)
                   for f in paths)
    with tempfile.TemporaryDirectory() as tmp:
        rec_path = str(Path(tmp) / "BENCH_torch.json")
        Path(rec_path).write_text(json.dumps(
            {"n": newest_n + 1, "rc": 0, "parsed": line}))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = sda_bench.main(["--check", "--advisory", "--json",
                                 *paths, rec_path])
    verdict = json.loads(out.getvalue().strip().splitlines()[-1])
    _check(rc == 0, f"sda-bench --check exited {rc}")
    _check(verdict.get("newest") == rec_path and not verdict["checked"],
           f"sda-bench --check: the torch line gated against {verdict}")
    print(f"sda-bench --check --advisory --json over {len(paths)} records "
          f"+ the bench line: exit {rc}, newest is the torch line, "
          f"{verdict['note']}")

    # the instrumented round against the bare one, cost capture off and on
    scheme, masking, host = bench.flagship(P, D)
    x = torch.from_numpy(host).to(dev)
    bare = fused_round.single_chip_round_pallas(scheme, masking, device=dev)
    wrapped = devprof.instrument("chip_smoke.round", bare,
                                 cost=bench._round_ops(scheme))
    gen = torch.Generator().manual_seed(3)
    # arms: the round bare, behind a plain Python frame, instrumented with
    # cost capture off and on, and bare with the garbage collector off
    calls = {"bare": bare, "passthrough": lambda a, b: bare(a, b),
             "capture_off": wrapped, "capture_on": wrapped,
             "bare_gc_off": bare}
    arms = tuple(calls)
    ab = {name: [] for name in arms}
    for i in range(AB_TURNS):               # each arm first in turn
        for name in arms[i % len(arms):] + arms[:i % len(arms)]:
            devprof.enable_cost_analysis(name == "capture_on")
            fn = calls[name]
            if name == "bare_gc_off":
                gc.disable()
            try:
                ab[name].append(_median_ms(lambda: fn(x, gen), reps=10,
                                           warmup=1)
                                if dev.type == "cuda" else None)
            finally:
                gc.enable()
    devprof.enable_cost_analysis(False)
    if dev.type == "cuda":
        ab_ms = {name: statistics.median(v) for name, v in ab.items()}
        faster = {name: sum(b < w for b, w in zip(ab["bare"], ab[name]))
                  for name in arms[1:]}
        print(f"round, median of {AB_TURNS} medians of 10, arms in turns: "
              + ", ".join(f"{name} {ms:.4f} ms (runs {min(ab[name]):.4f}"
                          f"-{max(ab[name]):.4f})"
                          for name, ms in ab_ms.items())
              + f"; bare faster in {faster} of {AB_TURNS} turns")
    else:
        ab_ms = dict.fromkeys(arms)
    # the wrapper's own host cost, a no-op wrapped (capture on: the memory
    # frame's allocator queries on the round's device)
    noop = devprof.instrument("chip_smoke.noop", lambda a, b: a,
                              cost=lambda a, b: 1)
    host_us = {}
    for name, fn, on in (("bare", lambda a, b: a, False),
                         ("capture_off", noop, False),
                         ("capture_on", noop, True)):
        devprof.enable_cost_analysis(on)
        t1 = time.perf_counter()
        for _ in range(10_000):
            fn(x, gen)
        host_us[name] = (time.perf_counter() - t1) / 10_000 * 1e6
    devprof.enable_cost_analysis(False)
    print("wrapper host cost a call (10,000 calls of a no-op): "
          + ", ".join(f"{k} {v:.2f} us" for k, v in host_us.items()))
    del x
    return {"stage": "bench", "seconds": bench_s, "k1_launches": launches,
            "k1_launches_by_lane": line["k1_launches"],
            "value": line["value"],
            "round_seconds_median": line["round_seconds_median"],
            "utilization": util, "k1_trace_ms": trace_ms, "k1_events_ms":
            k1_ms, "busy_share": prof["busy_share"],
            "gate": {"rc": rc, "checked": verdict["checked"],
                     "note": verdict.get("note")},
            "instrumented_ab_ms": ab, "instrumented_ms": ab_ms,
            "wrapper_host_us": host_us}


def streamed_profile(dev, P, D, chunk, out_sha256):
    """Phase 17: phase 15's streamed round once more, with cost capture on
    (each ``stream.step`` / ``stream.finale`` call's device-memory peak)
    and under ``torch.profiler`` (the device's busy share and its time by
    part, through ``utils.traceparse``); its output must be phase 15's,
    byte for byte, and K6 must have launched once a tile. Returns the
    phase's JSON record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from sda_tpu_torch.mesh import (StreamingAggregator,
                                    synthetic_device_block_provider32)
    from sda_tpu_torch.obs import devprof
    from sda_tpu_torch.protocol import ChaChaMasking
    from sda_tpu_torch.utils import traceparse

    scheme, _, p = _flagship()
    prov = synthetic_device_block_provider32(p, seed=15, max_value=1 << 20,
                                             device=dev)
    agg = StreamingAggregator(scheme, ChaChaMasking(p, D, 128),
                              participants_chunk=chunk, use_pallas=True,
                              device=dev)
    devprof.reset()
    devprof.enable_cost_analysis()
    k6 = _k6_reset()
    k7, _ = _k7_k8_reset()
    seed_calls0 = _count_seed_words()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # a warm-up step first, so the device's tracing runs before the
            # round starts (a trace started cold can miss the first tiles)
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1)
                         ) as prof:
                torch.ones(1, device=dev).add_(1)
                _sync(dev)
                prof.step()
                t0 = time.perf_counter()
                out = agg.aggregate_blocks(prov, P, D, seed=15)
                wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            prof.export_chrome_trace(str(Path(tmp) / "streamed.json"))
            trace = traceparse.load_latest_trace(tmp)
            trace_s = time.perf_counter() - t1
    finally:
        devprof.enable_cost_analysis(False)
    _check(hashlib.sha256(out.tobytes()).hexdigest() == out_sha256,
           "streamed round under the profiler != phase 15's output")
    tiles = -(-P // chunk) * -(-D // agg.dim_chunk)
    k6_launches, k7_launches = k6.launches, k7.launches
    dim_tiles = -(-D // agg.dim_chunk)
    _check(dev.type != "cuda" or (k6_launches, k7_launches) == (tiles,
                                                                dim_tiles),
           f"streamed round under the profiler: K6 launched {k6_launches} "
           f"times, K7 {k7_launches}; want {tiles} and {dim_tiles}")
    names = ("stream.step", "stream.finale")
    hbm = devprof.watermark_report(device=dev, names=names)
    busy = traceparse.busy_share(trace)
    stats = traceparse.device_module_stats(trace)
    top = sorted(stats.items(), key=lambda kv: -kv[1]["total_us"])[:6]
    # the device time by part: K3's, K1's, K6's, K7's and K8's kernels, the
    # rest of the block provider's (launched inside ``stream.feed``) and
    # the rest; a residue pass would be a device kernel named remainder
    split = {k: v / 1e3 for k, v in traceparse.device_split(
        trace, {"K3": "chacha_", "K1": "fused_round", "K6": K6_KERNEL,
                "K7": "reveal_kernel", "K8": "residues_kernel"},
        {"block provider": "stream.feed"}).items()}
    remainder_events = sum(st["count"] for name, st in stats.items()
                           if "remainder" in name.lower())
    # the device events a tile: what the hosts' ``stream.feed`` and
    # ``stream.dispatch`` ranges launched, by name; the step is the
    # reference's one donated program, so K6, K3's mask op (and its fold)
    # and K1 launch there, and nothing else but copies
    step_kernels = {"K6": K6_KERNEL, "K3 mask": "chacha_mask_kernel",
                    "K3 fold": "chacha_fold_kernel", "K1": "fused_round"}
    per_tile = collections.Counter()
    for names in traceparse.device_events_in(
            trace, {"feed": "stream.feed", "step": "stream.dispatch"}
    ).values():
        per_tile.update(names)
    per_tile = {name: count / tiles for name, count in per_tile.items()}
    by_kernel = {group: sum(c for name, c in per_tile.items() if hint in name)
                 for group, hint in step_kernels.items()}
    others = {name: c for name, c in per_tile.items()
              if not any(h in name for h in step_kernels.values())
              and not name.startswith(("gpu_memcpy", "gpu_memset"))}
    if dev.type == "cuda":
        _check(not others, f"streamed round under the profiler: a tile "
               f"launches {others} beside K6, K3 and K1")
        _check(all(by_kernel[g] == 1 for g in ("K6", "K3 mask", "K1")),
               f"streamed round under the profiler: a tile's K6, K3 mask "
               f"and K1 events {by_kernel}, want one each (the whole "
               f"trace's: " + str({g: sum(st["count"] for name, st in
                                        stats.items() if h in name)
                                   for g, h in step_kernels.items()})
               + f" in {tiles} tiles)")
    seed_calls = _count_seed_words() - seed_calls0
    _check(dev.type != "cuda" or seed_calls == 0,
           f"streamed round under the profiler: the seed words derived on "
           f"the host {seed_calls} times")
    _check(remainder_events == 0, f"streamed round under the profiler: "
           f"{remainder_events} device kernels named remainder (a residue "
           "pass the mask op should have folded)")
    print(f"streamed round under the profiler: wall {wall:.3f} s (trace "
          f"export and parse {trace_s:.1f} s), busy share {busy}, peak "
          f"device memory {hbm['hbm_peak_bytes']} bytes of a watermark of "
          f"{hbm['watermark_bytes']} ({hbm.get('hbm_watermark_ratio')}); "
          f"K6 {k6_launches} launches, K7 {k7_launches}; device events "
          f"named remainder {remainder_events}; device time, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    print(f"  device events a tile ({tiles} tiles): "
          + ", ".join(f"{n[:60]} {c:g}" for n, c in sorted(
              per_tile.items(), key=lambda kv: -kv[1]))
          + f"; host seed-word derivations {seed_calls}")
    for name, st in top:
        print(f"    {st['total_us'] / 1e3:10.3f} ms {st['count']:6d} calls"
              f"  {name[:100]}")
    return {"stage": "streamed_profile", "participants": P, "dim": D,
            "exact": True, "wall_s": wall, "busy_share": busy, "hbm": hbm,
            "device_ms_by_part": split, "k6_launches": k6_launches,
            "k7_launches": k7_launches,
            "remainder_device_events": remainder_events,
            "device_events": sum(st["count"] for st in stats.values()),
            "device_events_a_tile": per_tile,
            "step_kernels_a_tile": by_kernel,
            "seed_word_calls": seed_calls,
            "functions": devprof.report()}


def _k1_reset():
    from sda_tpu_torch.fields import fused_round

    k1 = fused_round.fused_mask_share_combine
    k1.launches = 0
    k1.instance_launches.update(dict.fromkeys(fused_round.INSTANCES, 0))
    return k1


def _k1_shard_hold(case, dev, scheme, masked, x, seed):
    """K1 at one pod shard's shape (``simpod._pallas_stage``'s call on a
    shard's residues ``x``), held to the plain version with
    ``torch.equal``. Returns the max |error| (0 when equal)."""
    import torch

    from sda_tpu_torch.fields import fused_round, numtheory
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.fields.sharing import batch_columns

    args = (batch_columns(x.to(torch.int32), scheme.secret_count), seed,
            SolinasPrime.try_from(scheme.prime_modulus),
            numtheory.share_matrix_for(scheme), scheme.privacy_threshold,
            masked)
    got = fused_round.fused_mask_share_combine(*args)
    want = fused_round.fused_mask_share_combine_plain(*args)
    err = 0
    for g, w in zip(got, want):
        _check(g.shape == w.shape, f"{case}: K1 {tuple(g.shape)} vs "
               f"{tuple(w.shape)}")
        if not torch.equal(g, w):
            err = max(err, int((g - w).abs().max()))
    _check(err == 0, f"{case}: K1 at shard shape {tuple(x.shape)} != plain "
           f"(max |err| {err})")
    print(f"  {case}: K1 at shard shape {tuple(x.shape)} (masked={masked}) "
          "equal to plain")
    return err


def k1_accumulate(dev, rng):
    """Phase 4: K1's accumulate options (the reference's donated streamed
    accumulators, ``sda_tpu/mesh/streaming.py:503-505``) held to plain:
    every instance a path runs, into accumulators near p - 1 (the mask
    one of the unbatched d columns, a ragged last column's padding
    dropped), each written in place and ``torch.equal`` to ``f.add`` of the
    fresh call's outputs (the plain version's): the flagship and the other
    schemes' column instances at P=33 x d=3003 (and the flagship at
    P_MAIN x D_MAIN), masked and not, the streamed tile's unmasked call at
    its full width (the plain version in column windows), external bits and
    the generic layout. Then the streamed tile's call is timed fresh and
    into its accumulator beside both bounds. Returns (the timing record,
    max |error|)."""
    import numpy as np
    import torch

    from sda_tpu_torch.benchmarks.bounds import k1_bound
    from sda_tpu_torch.fields import fused_round, numtheory
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.fields.sharing import batch_columns, unbatch_columns
    from sda_tpu_torch.utils.benchtime import median_ms

    K1 = fused_round.fused_mask_share_combine
    flagship, _, p = _flagship()
    t = flagship.privacy_threshold
    sp = SolinasPrime.try_from(p)
    m_flag = numtheory.share_matrix_for(flagship)
    err = 0

    def words(shape):
        return torch.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)).to(dev)

    def hold(case, instance, args, d, windows=1, **kw):
        """K1 into accumulators against plain; with ``windows`` the plain
        version runs on that many column windows (unmasked calls), each
        with its own columns' Philox draws (``philox_bits(col0=)``)."""
        nonlocal err
        x_cols, s_sp, m_host, masked = args[0], args[2], args[3], args[5]
        n_rows, B = np.shape(m_host)[0], x_cols.shape[2]
        _check(windows == 1 or not (masked or kw),
               f"{case}: column windows hold unmasked internal draws only")
        g = torch.Generator(device=dev).manual_seed(d)
        acc_s = s_sp.p - 1 - torch.randint(0, 3, (n_rows, B), device=dev,
                                           generator=g)
        acc_m = (s_sp.p - 1 - torch.randint(0, 3, (d,), device=dev,
                                            generator=g)) if masked else None
        into = (acc_s.clone(), None if acc_m is None else acc_m.clone())
        before = dict(K1.instance_launches)
        got = K1(*args, acc_shares=into[0], acc_mask=into[1], **kw)
        ran = [i for i in fused_round.INSTANCES
               if K1.instance_launches[i] != before[i]]
        _check(dev.type != "cuda" or ran == [instance],
               f"{case}: ran {ran}, want {instance}")
        _check(got[0].data_ptr() == into[0].data_ptr() and (
            acc_m is None or got[1].data_ptr() == into[1].data_ptr()),
            f"{case}: an accumulator was not written in place")
        width = -(-B // windows)
        for b0 in range(0, B, width):
            cols = slice(b0, min(B, b0 + width))
            if windows == 1:
                fresh = fused_round.fused_mask_share_combine_plain(*args,
                                                                   **kw)
                want = ((acc_s + fresh[0]) % s_sp.p,
                        fresh[1] if acc_m is None else
                        (acc_m + unbatch_columns(fresh[1], d)) % s_sp.p)
                pair = got
            else:
                bits = fused_round.philox_bits(
                    args[1], x_cols.shape[0], x_cols.shape[1], args[4],
                    cols.stop - b0, False, dev, col0=b0)
                fresh = fused_round.fused_mask_share_combine_plain(
                    x_cols[:, :, cols], *args[1:], external_bits=bits)
                del bits
                want = ((acc_s[:, cols] + fresh[0]) % s_sp.p, fresh[1])
                pair = (got[0][:, cols], got[1][:, cols])
            _sync(dev)
            for g_, w in zip(pair, want):
                _check(g_.shape == w.shape and g_.dtype == w.dtype,
                       f"{case}: {g_.dtype}{tuple(g_.shape)} vs "
                       f"{w.dtype}{tuple(w.shape)}")
                if not torch.equal(g_, w):
                    err = max(err, int((g_ - w).abs().max()))
                    _fail(f"{case}: kernel != plain version (max |err| "
                          f"{err}, columns {b0}..)")
            del fresh, want
        print(f"  {case} [{instance}] into accumulators: equal"
              + (f" ({windows} column windows of the plain version)"
                 if windows > 1 else ""))

    t0 = time.perf_counter()
    cases = 0
    for name, (k, ts, n_clerks, sharing) in (
            ("columns", (3, t, 8, None)), *K1_SCHEMES.items()):
        scheme = (flagship if sharing is None
                  else _sim_scheme(k, n_clerks, sharing))
        s_sp = SolinasPrime.try_from(scheme.prime_modulus)
        m_host = numtheory.share_matrix_for(scheme)
        for P, d in ((33, 3003),) + (((P_MAIN, D_MAIN),) if sharing is None
                                     else ()):
            x_cols = batch_columns(words((P, d)).view(torch.int32), k)
            for masked in (True, False):
                instance = name if masked else f"{name}_unmasked"
                hold(f"K1 accumulate k={k} t={ts} n={n_clerks} P={P} d={d} "
                     f"masked={masked}", instance,
                     (x_cols, 77 + P, s_sp, m_host, ts, masked), d)
                cases += 1
            del x_cols
    # the streamed tile's call (K3's int32 rows, unmasked, shares only) at
    # its full width, the plain version in 4 column windows (its Philox
    # draws of the whole tile need ~80 GB), external bits and the generic
    # layout
    _empty_cache(dev)
    x_cols = batch_columns(words((STREAM_CHUNK, D_TILE)).view(torch.int32),
                           3)
    hold(f"K1 accumulate streamed tile P={STREAM_CHUNK} d={D_TILE}",
         "columns_unmasked", (x_cols, 15, sp, m_flag, t, False), D_TILE,
         windows=4)
    del x_cols
    _empty_cache(dev)
    small = words((7, 3, 1000))
    hold("K1 accumulate external bits P=7 B=1000", "external",
         (small, 0, sp, m_flag, t, True), 2999,
         external_bits=words((7, 2 * (3 + t), 1000)))
    hold("K1 accumulate generic layout P=7 B=1000", "generic",
         (small, 5, sp, m_flag, t, True), 3000)
    cases += 3
    print(f"  K1's accumulate options: {cases} holds in "
          f"{time.perf_counter() - t0:.1f} s")
    # the streamed step's K1 call timed fresh and into its accumulator
    x_cols = batch_columns(words((STREAM_CHUNK, D_TILE)).view(torch.int32), 3)
    tile_args = (x_cols, 15, sp, m_flag, t, False)
    B_tile = x_cols.shape[-1]
    tile_acc = torch.zeros((8, B_tile), dtype=torch.int64, device=dev)
    on_card = dev.type == "cuda"
    rec = {"shape": [STREAM_CHUNK, 3, B_tile], "holds": cases,
           "ms": median_ms(lambda: K1(*tile_args), dev, reps=20)
           if on_card else None,
           "ms_accumulate": median_ms(lambda: K1(
               *tile_args, acc_shares=tile_acc), dev, reps=20)
           if on_card else None}
    for key, acc_rows in (("bound_ms", 0), ("bound_ms_accumulate", 8)):
        rec[key], rec[key.replace("ms", "by")], _ = k1_bound(
            STREAM_CHUNK, B_tile, 3, t, True, 8, acc_rows=acc_rows)
    print(f"  K1 at the streamed tile {rec['shape']} (columns_unmasked): "
          f"{rec['ms']} ms fresh, {rec['ms_accumulate']} ms into its "
          f"[8, {B_tile}] accumulator, median of 20; bounds "
          f"{rec['bound_ms']:.4f} / {rec['bound_ms_accumulate']:.4f} ms")
    del x_cols, tile_args, tile_acc
    _empty_cache(dev)
    return rec, err


def pod_phase(dev, P=P_MAIN, D=D_MAIN, reps=POD_REPS):
    """Phase 18: ``SimulatedPod`` at the flagship width on the 1x1 mesh of
    ``dev`` and on a virtual 4x2 mesh (``[dev] * 8``), Full, ChaCha and no
    masks, on K1 and on the plain lane, and a quorum reveal with clerk 5
    dropped; each round exact against the int64 column sum mod p, with its
    K1 and K3 launches (checked on a card: one K1 launch a shard, one K3
    window a shard on K1's lane, one a shard and participant chunk on the
    plain lane). K1 and K3 are then held to their plain versions at a 4x2
    shard's shape and offsets. Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.mesh import SimulatedPod, make_mesh
    from sda_tpu_torch.mesh import simpod
    from sda_tpu_torch.protocol import ChaChaMasking, NoMasking

    scheme, full, p = _flagship()
    on_card = dev.type == "cuda"
    inputs = torch.from_numpy(np.random.default_rng(18).integers(
        0, 1 << 20, size=(P, D), dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    masks = {"full": full, "chacha": ChaChaMasking(p, D, 128),
             "none": NoMasking()}
    meshes = {"1x1": make_mesh(1, 1, devices=[dev]),
              "4x2": make_mesh(4, 2, devices=[dev] * 8)}
    cases = [("1x1", "full", True, None, True),
             ("4x2", "full", True, None, True),
             ("4x2", "chacha", True, None, False),
             ("4x2", "none", True, None, False),
             ("4x2", "full", False, None, True),
             ("4x2", "chacha", False, None, False),
             ("4x2", "none", False, None, False),
             ("4x2", "full", True, (0, 1, 2, 3, 4, 6, 7), False)]
    k1, k3 = _k1_reset(), _k3_reset()
    rounds = []
    k1_total = 0  # every launch of the phase, timed repeats included
    seed0 = _count_seed_words()
    for shape, mask, pallas, survivors, timed in cases:
        pod = SimulatedPod(scheme, masks[mask], mesh=meshes[shape],
                           use_pallas=pallas, surviving_clerks=survivors)
        label = (f"{shape} {mask} {'K1' if pallas else 'plain'}"
                 + ("" if survivors is None else " quorum without clerk 5"))
        k1, k3 = _k1_reset(), _k3_reset()
        k7, k8 = _k7_k8_reset()
        t0 = time.perf_counter()
        out = pod.aggregate(inputs, seed=18)
        first_ms = (time.perf_counter() - t0) * 1e3
        k1_n, k3_n = k1.launches, k3.launches
        k7_n, k8_n = k7.launches, k8.launches
        _check(out.dtype == torch.int64 and out.shape == (D,),
               f"pod {label}: output {out.dtype}{tuple(out.shape)}")
        _check(torch.equal(out, expect), f"pod {label}: != column sum mod p")
        shards = pod.mesh.devices.size
        P_loc = P // pod.mesh.devices.shape[0]
        chunks = -(-P_loc // pod.scan_chunk)
        want_k1 = shards if pallas else 0
        want_k3 = 0 if mask != "chacha" else shards * (1 if pallas
                                                        else chunks)
        # one K7 reveal a d column; K8's residues on each K1 shard but
        # ChaCha's (K3's mask op reads the raw block)
        want_k7 = pod.mesh.devices.shape[1]
        want_k8 = shards if pallas and mask != "chacha" else 0
        if on_card:
            _check((k7_n, k8_n) == (want_k7, want_k8),
                   f"pod {label}: K7 and K8 launched {k7_n} and {k8_n} "
                   f"times, want {want_k7} and {want_k8}")
            _check(k1_n == want_k1, f"pod {label}: K1 launched {k1_n} "
                   f"times, want {want_k1}")
            _check(k3_n == want_k3, f"pod {label}: K3 launched {k3_n} "
                   f"times, want {want_k3}")
        ms = (_median_ms(lambda: pod.aggregate(inputs, seed=18), reps=reps,
                         warmup=1) if timed and on_card else None)
        k1_total += k1.launches
        rounds.append({"mesh": shape, "mask": mask, "k1": pallas,
                       "survivors": survivors, "exact": True,
                       "k1_launches": k1_n, "k3_launches": k3_n,
                       "k7_launches": k7_n, "k8_launches": k8_n,
                       "first_round_ms": first_ms, "round_ms": ms})
        print(f"  pod {label}: exact, K1 {k1_n}, K3 {k3_n}, K7 {k7_n}, K8 "
              f"{k8_n} launches, first "
              f"round {first_ms:.1f} ms"
              + ("" if ms is None else f", median of {reps} {ms:.3f} ms"))
    # the kernels at a 4x2 shard's shape and offsets: the last shard
    pod = SimulatedPod(scheme, masks["chacha"], mesh=meshes["4x2"],
                       use_pallas=True)
    P_pad, d_pad = pod.padded_shape(P, D)
    P_loc, d_loc = P_pad // 4, d_pad // 2
    pi, di = 3, 1
    rows = inputs[pi * P_loc:(pi + 1) * P_loc, di * d_loc:D]
    x = torch.zeros((P_loc, d_loc), dtype=torch.int64, device=dev)
    x[:, :rows.shape[1]] = pod._field.to_residues(rows)
    k1_err = max(_k1_shard_hold("pod shard (3, 1)", dev, scheme, masked, x,
                                simpod._tile_seed(18, pi, di))
                 for masked in (True, False))
    k3_err = _k3_window("pod shard (3, 1)", dev, 18, pi * P_loc, P_loc,
                        di * (d_loc // 8), d_loc, p, x=x,
                        out_dtype=torch.int32)
    key = lambda r: (f"{r['mesh']} {r['mask']} "
                     f"{'K1' if r['k1'] else 'plain'}"
                     + ("" if r["survivors"] is None else " quorum"))
    seed_calls = _count_seed_words() - seed0
    _check(not on_card or seed_calls == 0,
           f"pod: the seed words derived on the host {seed_calls} times")
    return {"stage": "pod_round", "participants": P, "dim": D,
            "seed_word_calls": seed_calls,
            "rounds": rounds, "k1_launches_phase": k1_total,
            "k7_launches": {key(r): r["k7_launches"] for r in rounds},
            "k8_launches": {key(r): r["k8_launches"] for r in rounds},
            "k1_shard_max_abs_err": k1_err,
            "k3_window_max_abs_err": k3_err,
            "k1_launches": {f"{r['mesh']} {r['mask']}"
                            f"{'' if r['survivors'] is None else ' quorum'}":
                            r["k1_launches"] for r in rounds if r["k1"]},
            "k3_launches": {f"{r['mesh']} {r['mask']} "
                            f"{'K1' if r['k1'] else 'plain'}":
                            r["k3_launches"] for r in rounds
                            if r["mask"] == "chacha"}}


def devscale_phase(dev, dim=DEVSCALE_DIM, rounds=2):
    """Phase 19: ``run_devscale`` at ``BENCH_r15_devscale.json``'s
    configuration (dim 1e8, P=8 on a 4x2 mesh, here virtual on ``dev``,
    full masks, seed 20260804) on K1, with the ``DeviceTileSink``-fed lane:
    exact against the sampled host oracle, the sink lane byte-identical
    to the device-generated one, the steps' recorded peak within the
    watermark, and on a card 8 K1 launches a tile in every round; every
    column of the warm and the last round against the int64 column sums of
    the device provider (``run_devscale``'s ``device_oracle``). Then one
    more round of the same pod, profiled (device time by operation, busy
    share), and K1 held to its plain version at a shard's shape of the
    model-scale tile, on the provider's rows with that shard's seed. K6
    must have launched at least once a tile of each round, and once a tile
    of the profiled round; it is held to its plain version at the round's
    first tile block [8, dim tile] (the provider's bounds of phase 14b) and
    at that shard's block. Returns the phase's JSON record."""
    from sda_tpu_torch.loadgen import DevScaleProfile, run_devscale
    from sda_tpu_torch.mesh import (StreamedPod, make_mesh, simpod,
                                    synthetic_device_block_provider32)

    on_card = dev.type == "cuda"
    k1, k3, k6 = _k1_reset(), _k3_reset(), _k6_reset()
    k7, k8 = _k7_k8_reset()
    t0 = time.perf_counter()
    rec = run_devscale(DevScaleProfile(
        dim=dim, participants=8, participants_chunk=8, p_shards=4,
        d_shards=2, mask="full", pallas=True, rounds=rounds,
        seed=20260804, device=str(dev)))
    wall = time.perf_counter() - t0
    # warm + timed rounds + the sink-fed round, 8 shards a tile each
    want = rec["tiles"] * 8 * (rounds + 1)
    _check(rec["exact"], f"devscale: not exact {rec['oracle']} "
           f"{rec['device_oracle']}")
    _check(rec["device_oracle"] == {"cols": dim, "outputs": 2},
           f"devscale: device oracle {rec['device_oracle']}")
    _check(rec["clerk_fed"]["exact"], "devscale: the sink-fed round's "
           "bytes differ from the device-generated round's")
    _check(rec["clerk_fed"]["sink_misses"] == 0,
           f"devscale: sink misses {rec['clerk_fed']}")
    _check(rec["hbm"]["within_watermark"], f"devscale: {rec['hbm']}")
    _check(rec["ok"] and rec["pallas"], "devscale: record not ok")
    if on_card:
        _check(k1.launches == want,
               f"devscale: K1 launched {k1.launches} times, want {want}")
        _check(k3.launches == 0, f"devscale: K3 launched {k3.launches}")
        _check(k6.launches >= rec["tiles"] * rounds,
               f"devscale: K6 launched {k6.launches} times for "
               f"{rec['tiles']} tiles x {rounds} rounds")
        # K8's residues a K1 shard, one K7 reveal a d column of 4 shards
        _check(k8.launches == k1.launches == 4 * k7.launches,
               f"devscale: K1, K7 and K8 launched {k1.launches}, "
               f"{k7.launches} and {k8.launches} times")
    k6_devscale = k6.launches
    k7_devscale, k8_devscale = k7.launches, k8.launches
    keep = ("value", "round_seconds_marginal", "dim", "dim_tile", "tiles",
            "p_shards", "d_shards", "exact", "oracle", "device_oracle",
            "clerk_fed",
            "hbm", "roofline_utilization", "compiled_shapes",
            "framework", "platform")
    out = {"stage": "devscale", **{key: rec[key] for key in keep},
           "k1_launches": k1.launches, "k6_launches": k6_devscale,
           "k7_launches": k7_devscale, "k8_launches": k8_devscale,
           "wall_s": wall}
    print(f"  devscale: dim {rec['dim']}, tile {rec['dim_tile']} x "
          f"{rec['tiles']}, value {rec['value']} elements/s, marginal "
          f"{rec['round_seconds_marginal']} s, exact {rec['exact']} (all "
          f"{rec['device_oracle']['cols']} columns of 2 rounds on the "
          f"device oracle), steps' peak {rec['hbm']['hbm_peak_bytes']} B "
          f"of a {rec['hbm']['watermark_bytes']} B watermark, K1 "
          f"{k1.launches} launches, K6 {k6_devscale} (the rounds and the "
          f"device oracle), K7 {k7_devscale}, K8 {k8_devscale}, wall "
          f"{wall:.1f} s")
    scheme, full, p = _flagship()
    pod = StreamedPod(scheme, full, mesh=make_mesh(4, 2, devices=[dev] * 8),
                      participants_chunk=8, dim_chunk=rec["dim_tile"],
                      use_pallas=True)
    prov = synthetic_device_block_provider32(p, seed=20260804, device=dev)
    if on_card:
        k6_before = k6.launches
        out["profile"] = _profile(
            "devscale round", lambda: pod.aggregate_blocks(prov, 8, dim, 7),
            reps=1)
        # _profile runs the round once before the profiled one
        _check(k6.launches - k6_before == 2 * rec["tiles"],
               f"devscale: K6 launched {k6.launches - k6_before} times in "
               f"two profiled rounds of {rec['tiles']} tiles")
    out["k1_launches_phase"] = k1.launches
    out["k6_launches_phase"] = k6.launches
    out["k7_launches_phase"] = k7.launches
    out["k8_launches_phase"] = k8.launches
    # K1 at the last shard of the warm round's first tile: its rows, its
    # columns and its seed (``_drive_stream``'s tile seed, then the
    # shard's)
    Pc_loc, d_loc = pod.participants_chunk // 4, pod.dim_chunk // 2
    pi, di = 3, 1
    x = pod._field.to_residues(prov(pi * Pc_loc, (pi + 1) * Pc_loc,
                                    di * d_loc, (di + 1) * d_loc))
    out["k1_shard_max_abs_err"] = _k1_shard_hold(
        "devscale shard (3, 1) of tile 0", dev, scheme, True, x,
        simpod._tile_seed(simpod._tile_seed(20260804, 0, 0), pi, di))
    del x
    k6_err = _k6_hold("devscale shard (3, 1) of tile 0", dev, pi * Pc_loc,
                      Pc_loc, di * d_loc, d_loc, 20260804, p)
    for bound in (p, *K6_BOUNDS):
        k6_err = max(k6_err, _k6_hold(
            "devscale tile 0", dev, 0, 8, 0, min(pod.dim_chunk, dim),
            20260804, bound))
    out["k6_max_abs_err"] = k6_err
    return out


def multihost_phase(dev, P=P_MAIN, D=D_MAIN, chunk=MH_CHUNK,
                    dim_chunk=MH_DIM_CHUNK, stop_after=MH_STOP):
    """Phase 20: ``mesh.multihost`` at world size 1 (NCCL on a card, gloo
    on the CPU) through a ``file://`` store: ``aggregate_process_local``
    on a one-slice 4x2 mesh of ``dev`` at P x D, then
    ``streamed_aggregate_process_local`` with a checkpoint every chunk,
    stopped by its provider after ``stop_after`` blocks, and resumed to
    the exact sum with fewer blocks fed; then K1 held to its plain version
    at a shard's shape of the streamed tile. The process group and the
    temporary directory are removed at the end. Returns the phase's JSON
    record."""
    import glob
    import os
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from sda_tpu_torch.mesh import (SimulatedPod, StreamedPod,
                                    make_multislice_mesh, multihost, simpod,
                                    synthetic_device_block_provider32)

    scheme, full, p = _flagship()
    on_card = dev.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="sda_multihost_")
    multihost.initialize(num_processes=1, process_id=0,
                         init_method=f"file://{tmp}/store", device=dev,
                         timeout_s=120)
    try:
        backend = dist.get_backend()
        mesh = make_multislice_mesh(1, 4, 2, devices=[dev] * 8)
        pod = SimulatedPod(scheme, full, mesh=mesh, use_pallas=True)
        inputs = torch.from_numpy(np.random.default_rng(20).integers(
            0, 1 << 20, size=(P, D), dtype=np.uint32)).to(dev)
        expect = (inputs.to(torch.int64).sum(0) % p).cpu().numpy()
        k1 = _k1_reset()
        t0 = time.perf_counter()
        out = multihost.aggregate_process_local(pod, inputs, seed=20)
        first_s = time.perf_counter() - t0
        k1_round = k1.launches
        _check(np.array_equal(out, expect),
               "multihost round: != column sum mod p")
        _check(not on_card or k1_round == 8,
               f"multihost round: K1 launched {k1_round} times, want 8")
        round_ms = _median_ms(
            lambda: multihost.aggregate_process_local(pod, inputs, seed=20),
            reps=3, warmup=0) if on_card else None
        print(f"  multihost ({backend}, world 1): aggregate_process_local "
              f"P={P} x d={D} exact, K1 {k1_round}, first round "
              f"{first_s:.3f} s (the communicator's set-up)"
              + ("" if round_ms is None
                 else f", then {round_ms:.3f} ms median of 3"))

        spod = StreamedPod(scheme, full, mesh=mesh, participants_chunk=chunk,
                           dim_chunk=dim_chunk, use_pallas=True)
        prov = synthetic_device_block_provider32(p, seed=20,
                                                 max_value=1 << 20,
                                                 device=dev)
        calls = {"n": 0, "limit": stop_after}

        def stopping(lp0, lp1, d0, d1):
            calls["n"] += 1
            if calls["n"] > calls["limit"]:
                raise RuntimeError("stopped")
            return prov(lp0, lp1, d0, d1)

        ck = os.path.join(tmp, "ck")
        k6 = _k6_reset()
        try:
            multihost.streamed_aggregate_process_local(
                spod, stopping, P, D, seed=21, checkpoint_path=ck,
                checkpoint_every_chunks=1)
            _fail("multihost streamed: the forced stop did not stop it")
        except RuntimeError as exc:
            _check(str(exc) == "stopped", f"multihost streamed: {exc}")
        _check(bool(glob.glob(ck + ".r0of1.*")),
               "multihost streamed: no snapshot after the stop")
        calls.update(n=0, limit=float("inf"))
        k1_before = k1.launches
        t0 = time.perf_counter()
        sout = multihost.streamed_aggregate_process_local(
            spod, stopping, P, D, seed=21, checkpoint_path=ck,
            checkpoint_every_chunks=1)
        resume_s = time.perf_counter() - t0
        k1_resumed = k1.launches - k1_before
        k1_total = k1.launches  # every launch of the phase
        # a block the provider fed is one K6 launch: the stopped run's
        # and the resumed run's
        k6_stream = k6.launches
        _check(not on_card or k6_stream == stop_after + calls["n"],
               f"multihost streamed: K6 launched {k6_stream} times for "
               f"{stop_after} + {calls['n']} blocks fed")
        tiles = -(-P // spod.participants_chunk) * -(-D // spod.dim_chunk)
        want = torch.zeros(D, dtype=torch.int64, device=dev)
        for p0 in range(0, P, chunk):
            want += prov(p0, min(p0 + chunk, P), 0, D).sum(0)
        _check(np.array_equal(sout, (want % p).cpu().numpy()),
               "multihost streamed: resumed round != column sum mod p")
        _check(spod.last_resumed and calls["n"] < tiles,
               f"multihost streamed: resumed {spod.last_resumed}, fed "
               f"{calls['n']} of {tiles} blocks")
        _check(not glob.glob(ck + ".r0of1.*"),
               "multihost streamed: snapshots left after completion")
        _check(not on_card or k1_resumed == 8 * calls["n"],
               f"multihost streamed: K1 launched {k1_resumed} times for "
               f"{calls['n']} blocks")
        print(f"  multihost streamed: {tiles} tiles, stopped after "
              f"{stop_after}, resumed with {calls['n']} blocks, exact, K1 "
              f"{k1_resumed}, K6 {k6_stream}, {resume_s:.3f} s; K1 "
              f"{k1_total} launches in the phase")
        # K1 at the last shard of the resumed round's first tile
        Pc_loc, d_loc = spod.participants_chunk // 4, spod.dim_chunk // 2
        pi, di = 3, 1
        x = spod._field.to_residues(prov(pi * Pc_loc, (pi + 1) * Pc_loc,
                                         di * d_loc, (di + 1) * d_loc))
        k1_err = _k1_shard_hold(
            "multihost streamed shard (3, 1) of tile 0", dev, scheme, True,
            x, simpod._tile_seed(simpod._tile_seed(21, 0, 0), pi, di))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"stage": "multihost", "backend": backend, "world_size": 1,
            "participants": P, "dim": D, "exact": True,
            "first_round_s": first_s, "round_ms": round_ms,
            "k1_launches_round": k1_round,
            "streamed_tiles": tiles, "resumed_blocks": calls["n"],
            "k1_launches_resumed": k1_resumed,
            "k1_launches_phase": k1_total, "k1_shard_max_abs_err": k1_err,
            "k6_launches": k6_stream, "k6_launches_phase": k6.launches,
            "resume_s": resume_s}


def _fedavg_batches(data, P, steps):
    """ix -> participant ix's [steps, batch] local batches (numpy) from its
    shard of ``data`` cut in ``P`` shards: ``run_fl``'s draw, (seed, 0x7A,
    round, participant)."""
    import numpy as np

    from sda_tpu_torch.fl.data import shard_dataset

    shards = shard_dataset(data[0], data[1], P, seed=0)

    def batches(ix):
        shard_x, shard_y = shards[ix]
        idx = np.random.default_rng([0, 0x7A, 0, ix]).integers(
            0, len(shard_x), size=(steps, min(FEDAVG_BATCH, len(shard_x))))
        return shard_x[idx], shard_y[idx]

    return batches


def _fedavg_cohort(dev, model, params, data, P, steps, lr, only=None):
    """Each of ``P`` participants (or those of ``only``, ids below ``P``)
    trains ``params`` (a dict of ``model``'s tensors, the rest of the
    module frozen) ``steps`` SGD steps (learning rate ``lr``) at batch
    ``FEDAVG_BATCH`` from its shard of ``data`` (``data`` cut in ``P``
    shards) through ``LocalTrainer`` on ``dev``, from the same global
    params. Returns the [P, d] float64 cohort on ``dev``, the global
    vector, its ``unravel``, each participant's ``local_fit`` time (ms),
    the cohort's training wall (s) and each one's mean loss."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sda_tpu_torch.models import LocalTrainer, ravel_pytree, sgd

    batches = _fedavg_batches(data, P, steps)

    def loss_fn(p, batch):
        x, y = batch
        return F.cross_entropy(torch.func.functional_call(model, p, (x,)),
                               y.long())

    trainer = LocalTrainer(loss_fn, sgd(lr), device=dev)
    gvec, unravel = ravel_pytree(params)
    ids = range(P) if only is None else only
    cohort = torch.empty((len(ids), gvec.numel()), dtype=torch.float64,
                         device=dev)

    def fit(ix):
        xs, ys = batches(ix)
        out, _, loss = trainer.fit(unravel(gvec), (), (
            torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)))
        return ravel_pytree(out)[0], float(loss)

    fit(0)  # warm: cuDNN's first calls, the allocator
    _sync(dev)
    times, losses = [], []
    t0 = time.perf_counter()
    for row, ix in enumerate(ids):
        t1 = time.perf_counter()
        vec, loss = fit(ix)
        cohort[row] = vec
        _sync(dev)
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
    wall = time.perf_counter() - t0
    _check(all(np.isfinite(losses)), f"local losses not finite: {losses}")
    _check(bool(torch.isfinite(cohort).all()), "a trained vector is not "
           "finite")
    return cohort, gvec, unravel, times, wall, losses


def _precision_turns(fn, turns=PRECISION_TURNS):
    """``fn()`` with cuDNN's TF32 off (``models.precision``'s stated
    setting) and on (torch's default), in turns, each first in turn:
    {"float32": [results], "tf32": [results]}."""
    from sda_tpu_torch.models import precision

    out = {"float32": [], "tf32": []}
    for i in range(turns):
        for tf32 in ((False, True) if i % 2 == 0 else (True, False)):
            precision.CUDNN_TF32 = tf32
            try:
                out["tf32" if tf32 else "float32"].append(fn())
            finally:
                precision.CUDNN_TF32 = False
    return out


def _mobilelite_precision(dev, model, params, data, P, kw, ids=(0, 1),
                          steps=2):
    """Phase 21: MobileLite's float32 training on ``dev`` against this
    machine's CPU from the same weights and batches. For participants
    ``ids``, ``steps`` SGD steps through ``LocalTrainer`` one at a time
    (their first batches of phase 21's draw): each step's loss is held
    within ``MOBILELITE_LOSS_TOL`` of the CPU's in the stated float32
    setting, and recorded with cuDNN's TF32 on beside it. A step at a
    time, because phase 21's 4-step mean losses part chaotically where a
    participant's SGD diverges (participant 1 by 3.1e-3, participant 0 by
    1e-5, in float32 on the card). Also the TF32 flags the scope sets, and
    participant 0's ``local_fit`` with TF32 off and on, in turns. Returns
    the record."""
    import torch
    import torch.nn.functional as F

    from sda_tpu_torch.models import LocalTrainer, MobileLite, precision, sgd

    lr = FEDAVG_LR["mobilelite"]
    cpu = torch.device("cpu")
    cpu_model = MobileLite(device=cpu, generator=torch.Generator(
        ).manual_seed(0), **(kw or {}))
    cpu_params = {k: v.detach() for k, v in cpu_model.state_dict().items()}
    _check(all(torch.equal(cpu_params[k], v.cpu()) for k, v in params.items()),
           "MobileLite: the CPU's initial weights are not the card's")
    batches = _fedavg_batches(data, P, FEDAVG_STEPS["mobilelite"])

    def step_losses(device, mdl, prm):
        def loss_fn(p, batch):
            x, y = batch
            return F.cross_entropy(torch.func.functional_call(mdl, p, (x,)),
                                   y.long())

        trainer = LocalTrainer(loss_fn, sgd(lr), device=device)
        out = []
        for ix in ids:
            xs, ys = batches(ix)
            p_ = prm
            for k in range(steps):
                p_, _, loss = trainer.fit(p_, (), (
                    torch.as_tensor(xs[k:k + 1], device=device),
                    torch.as_tensor(ys[k:k + 1], device=device)))
                out.append(float(loss))
        return out

    t0 = time.perf_counter()
    want = step_losses(cpu, cpu_model, cpu_params)
    cpu_s = time.perf_counter() - t0
    runs = _precision_turns(lambda: step_losses(dev, model, params), 1)
    diff = {k: max(abs(a - b) for a, b in zip(v[0], want))
            for k, v in runs.items()}
    _check(diff["float32"] <= MOBILELITE_LOSS_TOL,
           f"MobileLite step losses on {dev} {runs['float32'][0]} vs the "
           f"CPU's {want}: |diff| {diff['float32']} > {MOBILELITE_LOSS_TOL}")
    cudnn = torch.backends.cudnn
    with precision.float32_scope():
        matmul = torch.backends.cuda.matmul
        flags = {"cudnn.allow_tf32": cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32": matmul.allow_tf32,
                 "cudnn.conv.fp32_precision": str(getattr(getattr(
                     cudnn, "conv", None), "fp32_precision", None))}
    fit = _precision_turns(lambda: _fedavg_cohort(
        dev, model, params, data, P, FEDAVG_STEPS["mobilelite"], lr,
        only=(0,))[3][0])
    ab = {k: statistics.median(v) for k, v in fit.items()}
    print(f"  MobileLite, {steps} single SGD steps of participants "
          f"{list(ids)}: losses on {dev} within {diff['float32']:.3g} of the "
          f"CPU's in float32 (tolerance {MOBILELITE_LOSS_TOL}; with cuDNN "
          f"TF32 {diff['tf32']:.3g}; CPU {cpu_s:.1f} s); in the scope "
          f"{flags}; local_fit median of {PRECISION_TURNS}: float32 "
          f"{ab['float32']:.2f} ms, cuDNN TF32 {ab['tf32']:.2f} ms")
    return {"cpu_losses": want, "float32_losses": runs["float32"][0],
            "tf32_losses": runs["tf32"][0], "max_abs_diff": diff,
            "tolerance": MOBILELITE_LOSS_TOL, "flags_in_scope": flags,
            "local_fit_ms": fit, "local_fit_ms_median": ab}


def _lenet_precision(dev, losses):
    """Phase 25: ``fedavg_lenet``'s losses on ``dev`` (``losses``, its run
    in the stated float32 setting) against the same run on this machine's
    CPU, held within ``LENET_LOSS_TOL``; and its run on ``dev`` with
    cuDNN's TF32 on and off once more, in turns, beside them (torch's
    default, which the port ran with before it stated one). Returns the
    record."""
    import torch

    from sda_tpu_torch.examples import fedavg_lenet

    cpu = fedavg_lenet.run(torch.device("cpu"))["losses"]
    diff = max(abs(a - b) for a, b in zip(losses, cpu))
    _check(diff <= LENET_LOSS_TOL,
           f"fedavg_lenet: losses on {dev} {losses} vs the CPU's {cpu}: "
           f"|diff| {diff} > {LENET_LOSS_TOL}")

    def timed():
        t0 = time.perf_counter()
        run = fedavg_lenet.run(dev)["losses"]
        return run, time.perf_counter() - t0

    turns = _precision_turns(timed, 1)
    rec = {"cpu": cpu, "float32": losses, "max_abs_diff": diff,
           "tolerance": LENET_LOSS_TOL}
    for k, ((run, wall),) in turns.items():
        rec[f"{k}_again"] = run
        rec[f"{k}_wall_s"] = wall
        rec[f"{k}_max_abs_diff"] = max(abs(a - b) for a, b in zip(run, cpu))
    print(f"  fedavg_lenet: losses on {dev} in float32 within {diff:.3g} of "
          f"the CPU's {[round(v, 7) for v in cpu]} (tolerance "
          f"{LENET_LOSS_TOL}); once more, float32 within "
          f"{rec['float32_max_abs_diff']:.3g} ({rec['float32_wall_s']:.2f} s),"
          f" cuDNN TF32 within {rec['tf32_max_abs_diff']:.3g} "
          f"({rec['tf32_wall_s']:.2f} s)")
    return rec


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fedavg_oracle(codec, cohort, gvec, p):
    """The exact sum the pod must reveal: the host ``codec.encode`` of
    each participant's delta (float64 on the device, as
    ``pod_fedavg_round`` takes it), column sums mod p accumulated a
    participant at a time (no [P, d] host copy)."""
    import numpy as np

    acc = np.zeros(cohort.shape[1], dtype=np.int64)
    for row in cohort:
        acc += codec.encode((row - gvec).cpu().numpy())
        acc %= p
    return acc


def _captured(pod):
    """Wrap ``pod.aggregate`` to keep the sum of its last round."""
    seen = []
    inner = pod.aggregate

    def aggregate(inputs, seed=None):
        out = inner(inputs, seed)
        seen[:] = [out]
        return out

    pod.aggregate = aggregate
    return seen


def fedavg_phase(dev, P=P_FEDAVG, mobilelite_kw=None, lora_kw=None,
                 devscale_families=("mobilelite", "lora"), reps=3):
    """Phase 21: FedAvg on the card over the flagship packed-Shamir scheme
    (k=3, n=8, t=4, p = 2^29 - 679), Full masks, through the port's
    entry points. ``P`` participants train MobileLite (default width,
    3,731,890 parameters, 32x32x3 inputs) ``FEDAVG_STEPS["mobilelite"]``
    SGD steps each through ``LocalTrainer``, from the same global params,
    on ``fl/data.synthetic_classification`` at seed 0; their deltas go
    through ``pod_fedavg_round`` on ``SimulatedPod(use_pallas=True)`` over
    the 1x1 mesh and over the virtual 4x2 mesh, each round exact over
    every coordinate against the host ``codec.encode`` of each delta and
    the new global equal to ``global + decode_mean`` bit for bit; the new
    global is unravelled into the module for one eval pass. Then
    ``LoRAMLP()`` (default width, 11,782,400 adapter parameters on 28x28
    inputs, the base frozen on the card): ``P`` participants train their
    adapters, and ``pod_fedavg_round`` runs on
    ``StreamedPod(use_pallas=True)`` over the virtual 4x2 mesh at the
    watermark rule's tile, exact as above. Then ``run_devscale`` with each
    of ``devscale_families``, exact. K1 is held to its plain version at
    the 1x1 shard, a 4x2 shard and a streamed tile's shard.
    ``mobilelite_kw``/``lora_kw`` shrink the families for a rehearsal on
    the CPU. Returns the phase's JSON record."""
    import math

    import numpy as np
    import torch

    from sda_tpu_torch.fl.data import synthetic_classification
    from sda_tpu_torch.loadgen import DevScaleProfile, run_devscale
    from sda_tpu_torch.mesh import (SimulatedPod, StreamedPod, make_mesh,
                                    simpod, watermark_dim_tile)
    from sda_tpu_torch.models import (FixedPointCodec, LoRAMLP, MobileLite,
                                      lora_adapter_params, pod_fedavg_round)

    scheme, full, p = _flagship()
    on_card = dev.type == "cuda"
    # device memory allocated when the phase starts (earlier phases' live
    # tensors), and the peak of each part of the phase
    at_start = torch.cuda.memory_allocated(dev) if on_card else None
    peaks = {}
    _peak(dev)
    # fl/scenario.py::_make_codec's rule for the widest grid, on p
    q_cap = (p // 2 - 1) // P
    frac_bits = min(16, int(math.floor(math.log2(q_cap / FEDAVG_CLIP))))
    codec = FixedPointCodec(p, frac_bits, P, clip=FEDAVG_CLIP)
    k1 = _k1_reset()
    launches, k1_total, rounds = {}, 0, {}

    def fedavg_round(label, pod, cohort, gvec, want, seed, shards_a_round):
        """Warm round (its sum ``want``, its new global ``global +
        decode_mean(want)``), then the median of ``reps`` timed ones."""
        nonlocal k1_total
        seen = _captured(pod)
        _k1_reset()
        t0 = time.perf_counter()
        new_vec = pod_fedavg_round(pod, codec, gvec, cohort, seed)
        first_ms = (time.perf_counter() - t0) * 1e3
        n = k1.launches
        _check(not on_card or n == shards_a_round,
               f"fedavg {label}: K1 launched {n} times, want "
               f"{shards_a_round}")
        summed = seen[0]
        summed = (summed.cpu().numpy() if isinstance(summed, torch.Tensor)
                  else np.asarray(summed))
        _check(summed.shape == want.shape and np.array_equal(summed, want),
               f"fedavg {label}: pod sum != host encode column sums mod p")
        g_host = gvec.cpu().numpy()
        _check(np.array_equal(new_vec, g_host + codec.decode_mean(want, P)),
               f"fedavg {label}: new global != global + decode_mean")
        ms = (_median_ms(lambda: pod_fedavg_round(pod, codec, gvec, cohort,
                                                  seed), reps=reps,
                         warmup=0) if on_card else None)
        k1_total += k1.launches
        launches[label] = n
        rounds[label] = {"exact": True, "cols": int(want.size),
                         "k1_launches": n, "first_round_ms": first_ms,
                         "round_ms": ms}
        print(f"  fedavg {label}: exact over all {want.size} columns, K1 "
              f"{n} launches a round, first round {first_ms:.1f} ms"
              + ("" if ms is None else f", median of {reps} {ms:.1f} ms"))
        return new_vec

    # -- MobileLite, P participants, SimulatedPod 1x1 and 4x2 --------------
    gen = torch.Generator().manual_seed(0)
    mob = MobileLite(device=dev, generator=gen, **(mobilelite_kw or {}))
    mob_params = {k: v.detach() for k, v in mob.state_dict().items()}
    data = synthetic_classification(P * FEDAVG_SHARD, FEDAVG_EVAL,
                                    image_shape=(32, 32, 3), seed=0)
    cohort, gvec, unravel, fit_ms, fit_wall, mob_losses = _fedavg_cohort(
        dev, mob, mob_params, data, P, FEDAVG_STEPS["mobilelite"],
        FEDAVG_LR["mobilelite"])
    d_mob = int(gvec.numel())
    print(f"  MobileLite: d={d_mob}, {P} participants x "
          f"{FEDAVG_STEPS['mobilelite']} steps, local_fit median "
          f"{statistics.median(fit_ms):.1f} ms, cohort {fit_wall:.2f} s, "
          f"mean loss {statistics.mean(mob_losses):.4f}")
    mob_precision = _mobilelite_precision(dev, mob, mob_params, data, P,
                                          mobilelite_kw)
    meshes = {"1x1": make_mesh(1, 1, devices=[dev]),
              "4x2": make_mesh(4, 2, devices=[dev] * 8)}
    pods = {name: SimulatedPod(scheme, full, mesh=mesh, use_pallas=True)
            for name, mesh in meshes.items()}
    want = _fedavg_oracle(codec, cohort, gvec, p)
    for name, pod in pods.items():
        new_vec = fedavg_round(f"mobilelite {name}", pod, cohort, gvec, want,
                               21, pod.mesh.devices.size)
    profile = None
    if on_card:
        _k1_reset()
        profile = _profile("fedavg pod round 4x2 (MobileLite)",
                           lambda: pod_fedavg_round(pods["4x2"], codec, gvec,
                                                    cohort, 21), reps=reps)
        k1_total += k1.launches
    mob.load_state_dict(unravel(torch.from_numpy(new_vec)))
    with torch.no_grad():
        logits = mob(torch.as_tensor(data[2], device=dev))
    _check(tuple(logits.shape) == (FEDAVG_EVAL, 10)
           and bool(torch.isfinite(logits).all()),
           f"eval pass: logits {tuple(logits.shape)}")
    accuracy = float((logits.argmax(-1).cpu()
                      == torch.as_tensor(data[3]).long()).float().mean())
    print(f"  eval pass of the new global on {dev.type}: logits "
          f"{tuple(logits.shape)} finite, accuracy {accuracy:.4f}")
    peaks["mobilelite rounds"] = _peak(dev)
    # K1 at the pods' shard shapes, on the encoded cohort (the cohort
    # freed first: K1's plain version at the 1x1 shard is the phase's
    # largest allocation)
    encoded = codec.encode_device(
        (cohort - gvec[None, :]).to(torch.float32), device=dev)
    P_pad, d_pad = pods["1x1"].padded_shape(P, d_mob)
    x1 = torch.zeros((P_pad, d_pad), dtype=torch.int64, device=dev)
    x1[:P, :d_mob] = encoded
    P_pad, d_pad = pods["4x2"].padded_shape(P, d_mob)
    P_loc, d_loc = P_pad // 4, d_pad // 2
    x4 = torch.zeros((P_loc, d_loc), dtype=torch.int64, device=dev)
    rows = encoded[3 * P_loc:4 * P_loc, d_loc:]
    x4[:rows.shape[0], :rows.shape[1]] = rows
    del cohort, encoded, rows, pods
    _empty_cache(dev)
    holds = [_k1_shard_hold("fedavg 1x1 shard", dev, scheme, True, x1,
                            simpod._tile_seed(21, 0, 0))]
    del x1
    holds.append(_k1_shard_hold("fedavg 4x2 shard (3, 1)", dev, scheme,
                                True, x4, simpod._tile_seed(21, 3, 1)))
    del x4
    _empty_cache(dev)
    peaks["mobilelite shard holds"] = _peak(dev)

    # -- LoRA adapters, P participants, StreamedPod 4x2 --------------------
    lora = LoRAMLP(device=dev, generator=torch.Generator().manual_seed(0),
                   **(lora_kw or {}))
    adapters = {k: v.detach() for k, v in lora_adapter_params(lora).items()}
    data = synthetic_classification(P * FEDAVG_SHARD, FEDAVG_EVAL,
                                    image_shape=(28, 28, 1), seed=0)
    cohort, gvec, unravel, lora_ms, lora_wall, losses = _fedavg_cohort(
        dev, lora, adapters, data, P, FEDAVG_STEPS["lora"], FEDAVG_LR["lora"])
    d_lora = int(gvec.numel())
    print(f"  LoRAMLP adapters: d={d_lora}, {P} participants x "
          f"{FEDAVG_STEPS['lora']} steps, local_fit median "
          f"{statistics.median(lora_ms):.1f} ms, cohort {lora_wall:.2f} s, "
          f"mean loss {statistics.mean(losses):.4f}")
    tile = watermark_dim_tile(scheme, full, participants_chunk=P,
                              p_shards=4, d_shards=2, pallas=True, dim=d_lora,
                              shards_per_device=8, device=dev)
    spod = StreamedPod(scheme, full, mesh=meshes["4x2"], participants_chunk=P,
                       dim_chunk=tile, use_pallas=True)
    tiles = -(-d_lora // spod.dim_chunk)
    fedavg_round("lora streamed 4x2", spod, cohort, gvec,
                 _fedavg_oracle(codec, cohort, gvec, p), 22, 8 * tiles)
    peaks["lora round"] = _peak(dev)
    rounds["lora streamed 4x2"].update(dim_tile=spod.dim_chunk, tiles=tiles)
    Pc_loc, d_loc = spod.participants_chunk // 4, spod.dim_chunk // 2
    rows = codec.encode_device(
        (cohort[3 * Pc_loc:4 * Pc_loc, d_loc:2 * d_loc]
         - gvec[None, d_loc:2 * d_loc]).to(torch.float32), device=dev)
    x = torch.zeros((Pc_loc, d_loc), dtype=torch.int64, device=dev)
    x[:rows.shape[0], :rows.shape[1]] = rows
    holds.append(_k1_shard_hold(
        "fedavg streamed shard (3, 1) of tile 0", dev, scheme, True, x,
        simpod._tile_seed(simpod._tile_seed(22, 0, 0), 3, 1)))
    del cohort, rows, x
    _empty_cache(dev)

    # before run_devscale, whose cost capture resets the peak counter at
    # each instrumented step (its record carries its own)
    peaks["lora shard hold"] = _peak(dev)

    # -- run_devscale at the families' widths ------------------------------
    devscale = {}
    for family in devscale_families:
        _k1_reset()
        rec = run_devscale(DevScaleProfile(
            family=family, dim=0, participants=8, participants_chunk=8,
            p_shards=4, d_shards=2, mask="full", pallas=True, rounds=2,
            seed=20260805, device=str(dev)))
        want = rec["tiles"] * 8 * 3  # warm + timed + the sink-fed round
        _check(rec["exact"] and rec["ok"] and rec["family"] == family,
               f"devscale {family}: {rec.get('oracle')} "
               f"{rec.get('device_oracle')}")
        _check(rec["dim"] == {"mobilelite": 3_731_890,
                              "lora": 11_782_400}[family],
               f"devscale {family}: dim {rec['dim']}")
        _check(not on_card or k1.launches == want,
               f"devscale {family}: K1 launched {k1.launches} times, want "
               f"{want}")
        k1_total += k1.launches
        launches[f"devscale {family}"] = k1.launches
        devscale[family] = {key: rec[key] for key in (
            "value", "round_seconds_marginal", "dim", "dim_tile", "tiles",
            "exact", "device_oracle", "hbm")}
        print(f"  run_devscale family={family}: dim {rec['dim']}, value "
              f"{rec['value']} elements/s, exact, K1 {k1.launches} launches")

    return {"stage": "fedavg", "participants": P,
            "fractional_bits": frac_bits, "clip": FEDAVG_CLIP,
            "mobilelite": {"dim": d_mob, "steps": FEDAVG_STEPS["mobilelite"],
                           "lr": FEDAVG_LR["mobilelite"],
                           "local_fit_ms_median": statistics.median(fit_ms),
                           "training_wall_s": fit_wall,
                           "mean_loss": statistics.mean(mob_losses),
                           "eval_accuracy": accuracy,
                           "precision": mob_precision},
            "lora": {"dim": d_lora, "steps": FEDAVG_STEPS["lora"],
                     "lr": FEDAVG_LR["lora"],
                     "local_fit_ms_median": statistics.median(lora_ms),
                     "training_wall_s": lora_wall,
                     "mean_loss": statistics.mean(losses)},
            "rounds": rounds, "devscale": devscale,
            "k1_launches": launches, "k1_launches_phase": k1_total,
            "k1_shard_max_abs_err": max(holds),
            "device_bytes_at_start": at_start, "peak_device_bytes": peaks,
            "pod_round_profile": profile}


def _sim(label, argv, smi=""):
    """``sda_tpu_torch.cli.sim.main(argv)`` in this process: it must return
    0 and print exactly one JSON line, which is returned with the K1 and
    K3 launches of the run (counted from 0 just before it)."""
    from sda_tpu_torch.cli import sim

    k1, k3 = _k1_reset(), _k3_reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = sim.main(argv)
    wall = time.perf_counter() - t0
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("{")]
    _check(rc == 0, f"sim {label}: exit code {rc} {lines[-1:]}")
    _check(len(lines) == 1, f"sim {label}: {len(lines)} JSON lines")
    rec = json.loads(lines[0])
    launches = {"k1": k1.launches, "k1_by_instance": dict(
        k1.instance_launches), "k3": k3.launches,
        "k3_by_op": dict(k3.op_launches)}
    print(f"  sim {label}: {rec.get('mode')}, exact {rec.get('exact')}, "
          f"seconds {rec.get('seconds')}, elements_per_sec "
          f"{rec.get('elements_per_sec', rec.get('value'))}, wall "
          f"{wall:.1f} s; K1 {launches['k1_by_instance']}, K3 "
          f"{launches['k3_by_op']}, the sim's own count "
          f"{rec.get('launches')} ({smi})")
    return rec, launches, wall


@contextlib.contextmanager
def _recorder_env(spool):
    """With a spool directory, ``SDA_FLIGHT_RECORDER`` names it while
    entered (the in-process sim installs its recorder from it, the fleet
    workers it spawns inherit it); on exit this process's recorder is
    sealed and detached and the variable restored."""
    import os

    from sda_tpu_torch.obs import recorder

    if spool is None:
        yield
        return
    saved = os.environ.get(recorder.RECORDER_DIR_ENV)
    os.environ[recorder.RECORDER_DIR_ENV] = spool
    try:
        yield
    finally:
        recorder.uninstall()
        if saved is None:
            os.environ.pop(recorder.RECORDER_DIR_ENV)
        else:
            os.environ[recorder.RECORDER_DIR_ENV] = saved


def _fleet_checks(name, rec, spool=None):
    """``ci.sh``'s assertions on the fleet drill's report (two ``sdad``
    workers over one sqlite store, chaos on) or, with its spool, on the
    forensics drill's: ``forensics.explain`` over the spools alone reaches
    ``revealed`` with every admitted participation, at least three
    processes, the chaos faults attributed and the reveal's digest; and
    ``sda-trace segments`` and ``slo`` exit 0 on the spool. Returns what
    the phase's record keeps."""
    _check(rec["ready"] and rec["exact"], f"sim {name}: {rec}")
    if spool is None:
        _check(rec["fleet_nodes"] == 2 and rec["client_failures"] == 0
               and rec["leaked"] == 0 and rec["chaos_rate"] > 0
               and isinstance(rec["scaling_efficiency"], float)
               and all(rps > 0 for rps in rec["per_node_load_rps"].values()),
               f"sim {name}: {rec}")
        return {key: rec[key] for key in (
            "fleet_nodes", "value", "baseline_rps", "scaling_efficiency",
            "per_node_load_rps", "client_failures", "leaked", "host_cores")}
    from sda_tpu_torch.cli import tracecli
    from sda_tpu_torch.obs import forensics

    _check(bool(rec["output_sha256"]), f"sim {name}: no output digest")
    rep = forensics.explain(forensics.load_spool(spool), rec["aggregation"])
    _check(len(rep["processes"]) >= 3,
           f"sim {name}: spools of {rep['processes']}")
    _check(rep["participations"]["created"] == rec["admitted_participations"],
           f"sim {name}: {rep['participations']} spooled, "
           f"{rec['admitted_participations']} admitted")
    _check(rep["final_state"] == "revealed", f"sim {name}: {rep['states']}")
    _check(bool(rep["faults"]) and all(
        f["site"] and f["kind"] for f in rep["faults"]),
        f"sim {name}: faults {rep['faults']}")
    _check(bool(rep["reveal"]) and rep["reveal"]["output_sha256"]
           == rec["output_sha256"], f"sim {name}: reveal {rep['reveal']}")
    for command in ("segments", "slo"):
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tracecli.main(["--spool", spool, command])
        _check(rc == 0, f"sda-trace {command} exited {rc}")
    print(f"  sim {name}: {rep['spans']} spans from "
          f"{len(rep['processes'])} processes, "
          f"{rep['participations']['created']} participations, "
          f"{len(rep['faults'])} faults attributed, states "
          f"{'->'.join(s['state'] for s in rep['states'])}, reveal digest "
          "match")
    return {"spans": rep["spans"], "processes": len(rep["processes"]),
            "participations": rep["participations"]["created"],
            "faults": len(rep["faults"]), "final_state": rep["final_state"]}


def _sim_shard_hold(case, dev, pod, rows, shape, seed, masked=True):
    """K1 held to plain (``_k1_shard_hold``) on a sim run's ``rows`` as one
    shard of ``pod`` saw them: their residues zero-padded to ``shape``."""
    import torch

    x = torch.zeros(shape, dtype=torch.int64, device=dev)
    r = rows[:shape[0], :shape[1]]
    x[:r.shape[0], :r.shape[1]] = pod._field.to_residues(r.to(dev))
    return _k1_shard_hold(case, dev, pod.scheme, masked, x, seed)


def sim_phase(dev, smi="", P=P_MAIN, D=D_MAIN, chunk=SIM_CHUNK,
              devscale_family="mobilelite"):
    """Phase 22: the port's ``sda-sim`` (``cli/sim.main``) in this process
    at P x D, each run exact by its own ``--verify``: (a) the pod on K1
    (full masks, one shard, a warm and a timed round: 2 K1 launches on a
    card); (b) the streamed round on K1 and K3 (ChaCha masks, participant
    chunks of ``chunk``: one K1 launch and one K3 window a tile, the tiling
    as the sim reports it); (c) the quorum reveal without clerk 6 on K1;
    (g) BasicShamir at 8 clerks and (h) packed Shamir at 26 clerks with 7
    secrets a batch (k=7, t=8), full masks, each on its (k, t)'s column
    instance of K1 (2 launches on a card); (d) one multihost worker
    process (NCCL on a card, gloo on the CPU, world size 1, a mesh of 8
    entries of its device), whose one JSON line
    the coordinator forwards, with the launches the worker counted (one
    K1 launch a shard a round: 16); (e) the devscale profile at
    ``devscale_family``'s width on K1, exact on the device oracle; (f) the
    drill profiles at ``ci.sh``'s sizes, each exact, with the K3 calls
    of each counted against its launches and held to the plain version on
    the seeds it drew. Then K1 held to its plain version at (a)'s shard,
    (b)'s first tile, (g)'s and (h)'s shards, (d)'s last shard and (e)'s
    last shard of its first tile, and K3 at (b)'s windows, each on the
    rows and seeds its run drew.
    Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.mesh import SimulatedPod, make_mesh, simpod
    from sda_tpu_torch.mesh.streaming import synthetic_device_block_provider32
    from sda_tpu_torch.protocol import FullMasking

    scheme, full, p = _flagship()
    sim_schemes = {"basic": _sim_scheme(1, 8, "basic"),
                   "packed26": _sim_scheme(7, 26, "packed")}
    on_card = dev.type == "cuda"
    device = ["--device", str(dev)]
    base = ["--participants", str(P), "--dim", str(D), "--verify", *device]
    pallas = ["--pallas"] if on_card else []
    runs, launches = {}, {}
    seed0 = _count_seed_words()

    def run(name, argv):
        rec, n, wall = _sim(name, argv, smi)
        _check(rec.get("exact") is True, f"sim {name}: not exact {rec}")
        runs[name] = {key: rec.get(key) for key in (
            "mode", "participants", "dim", "prime", "pallas", "exact",
            "dropped_clerks", "seconds", "elements_per_sec", "tiles",
            "tile_shape")}
        runs[name]["wall_s"] = wall
        launches[name] = n
        if "--multihost" not in argv:
            # the sim's own count of its rounds' launches agrees with the
            # counters read around it (the worker's (d) has only its own)
            _check(rec["launches"] == {"k1": n["k1"], "k3": n["k3"]},
                   f"sim {name}: reports launches {rec['launches']}, "
                   f"counted {n}")
        return rec, n

    # (a) the pod on K1
    rec, n = run("pod", [*base, "--clerks", "8", "--mask", "full", *pallas])
    _check(rec["mode"] == "simpod mesh (1, 1)" and rec["pallas"] == on_card
           and rec["prime"] == p, f"sim pod: {rec}")
    _check(not on_card or n["k1"] == 2,
           f"sim pod: K1 launched {n['k1']} times, want 2")
    # (b) the streamed round on K1 and K3
    rec, n = run("streamed", [*base, "--streaming", "--mask", "chacha",
                              "--participants-chunk", str(chunk), *pallas])
    _check(rec["mode"] == "streaming" and rec["pallas"] == on_card,
           f"sim streamed: {rec}")
    tiles, (rows, width) = rec["tiles"], rec["tile_shape"]
    if on_card:
        _check(n["k1"] == tiles and n["k1_by_instance"][
            "columns_unmasked"] == tiles,
            f"sim streamed: K1 {n['k1_by_instance']}, want {tiles} on "
            "columns_unmasked")
        _check(n["k3_by_op"]["mask"] == tiles and
               n["k3_by_op"]["expand"] == 0,
               f"sim streamed: K3 {n['k3_by_op']}, want {tiles} mask ops")
    # (c) the quorum reveal
    rec, n = run("quorum", [*base, "--drop-clerks", "6", *pallas])
    _check(rec["dropped_clerks"] == [6], f"sim quorum: {rec}")
    _check(not on_card or n["k1"] == 2,
           f"sim quorum: K1 launched {n['k1']} times, want 2")
    # (g) BasicShamir at 8 clerks and (h) the 26-clerk committee (k=7,
    # t=8): K1's column instances of their (k, t), a warm and a timed round
    t_gh = time.perf_counter()
    for name, argv, instance in (
            ("basic", ["--sharing", "basic"], "columns_k1t3"),
            ("packed26", ["--secrets-per-batch", "7", "--clerks", "26"],
             "columns_k7t8")):
        rec, n = run(name, [*base, *argv, "--mask", "full", *pallas])
        _check(rec["mode"] == "simpod mesh (1, 1)" and rec["pallas"] == on_card
               and rec["prime"] == sim_schemes[name].prime_modulus,
               f"sim {name}: {rec}")
        _check(not on_card or (n["k1"] == 2 and n["k1_by_instance"][
            instance] == 2), f"sim {name}: K1 {n['k1_by_instance']}, want 2 "
            f"on {instance}")
    gh_s = time.perf_counter() - t_gh
    # (d) one multihost worker process
    _empty_cache(dev)
    rec, n = run("multihost", [*base, "--multihost", "1",
                               "--devices-per-process", "8", *pallas])
    _check(rec["mode"] == "multihost x1 simpod mesh (8, 1)"
           and rec["pallas"] == on_card, f"sim multihost: {rec}")
    # K1 and K3 ran in the worker: the launches are its own count, one K1
    # launch a shard a round (warm + timed)
    launches["multihost"] = {**rec["launches"], "counted_by": "worker"}
    _check(not on_card or rec["launches"] == {"k1": 8 * 2, "k3": 0},
           f"sim multihost: the worker launched {rec['launches']}, want "
           "K1 16, K3 0")
    # (e) the devscale profile through the sim's dispatch
    _empty_cache(dev)
    rec, n, _ = _sim("devscale", ["--devscale", "--devscale-family",
                                  devscale_family, "--devscale-pallas",
                                  *device], smi)
    _check(rec["ok"] and rec["exact"] and rec["device_oracle"]["cols"]
           == rec["dim"], f"sim devscale: {rec}")
    # one K1 launch a shard a tile in each round: the warm and timed ones
    # and the sink-fed one (no scan lane at a model's width)
    _check("scan_lane" not in rec, f"sim devscale: a scan lane ran {rec}")
    want = (rec["tiles"] * rec["p_shards"] * rec["d_shards"]
            * (rec["rounds"] + ("clerk_fed" in rec)))
    _check(not on_card or n["k1"] == want,
           f"sim devscale: K1 launched {n['k1']} times, want {want}")
    drec = rec
    runs["devscale"] = {key: rec.get(key) for key in (
        "dim", "tiles", "dim_tile", "p_shards", "d_shards", "rounds",
        "seed", "value", "round_seconds_marginal", "exact", "device_oracle",
        "platform")}
    launches["devscale"] = n
    # (f) the drill profiles at ci.sh's sizes (every share sealed by the
    # port's host crypto)
    drills = {"load": ["--load", "--participants", "24", "--dim", "4",
                       "--load-arrivals", "closed", "--load-concurrency",
                       "8", "--load-seed", "20260803"],
              "chaos": ["--chaos", "--dead-clerks", "1", "--chaos-seed",
                        "20260803", "--chaos-rate", "0.05"],
              "pickup": ["--pickup", "--pickup-snapshots", "6",
                         "--pickup-interval", "0.5", "--pickup-wait", "10",
                         "--pickup-seed", "20260803"],
              "soak": ["--soak", "--soak-tenants", "2", "--soak-epochs", "3",
                       "--soak-participants", "4", "--soak-seed",
                       "20260803"],
              "analytics": ["--analytics", "histogram,countmin",
                            "--analytics-participants", "4",
                            "--analytics-epochs", "2", "--analytics-seed",
                            "20260806"],
              "tree": ["--tree", "--participants", "24", "--dim", "4",
                       "--tree-group-size", "6", "--tree-seed", "20260803",
                       "--tree-dropout", "0.1", "--tree-sim", "100000"],
              "fl": ["--fl", "--participants", "8", "--fl-family", "lenet",
                     "--fl-rounds", "3", "--fl-local-steps", "6",
                     "--fl-batch", "32", "--fl-target", "0.8",
                     "--fl-churn", "0.25", "--fl-dead-clerks", "1",
                     "--fl-store", "sqlite", "--fl-http", "--fl-seed",
                     "20260803"],
              "fleet": FLEET_DRILL,
              "forensics": [*FLEET_DRILL, "--load-churn", "0.3"]}
    # Their masks cancel inside a round, so an exact reveal cannot see a
    # wrong K3 call: each drill's K3 calls are recorded, counted against
    # its launches and held to plain on the seeds it drew (the first
    # expand and the first combine of each shape, modulus and PRG).
    k3 = _k3_reset()
    drill_rec, k3_drill_err = {}, 0
    for name, argv in drills.items():
        replayed = k3.replayed
        with tempfile.TemporaryDirectory() as tmp:
            # the forensics drill spools every process's telemetry
            spool = tmp if name == "forensics" else None
            with _recorder_env(spool), K3Calls() as k3_calls:
                rec, n, wall = _sim(name, [*argv, *device], smi)
            fleet = _fleet_checks(name, rec, spool) \
                if name in ("fleet", "forensics") else None
        _check(rec.get("exact") is True, f"sim {name}: {rec}")
        ops = collections.Counter(op for op, _, _ in k3_calls.calls)
        # one launch a call, and one expand more for a combine whose
        # flagged seeds it replayed
        by_op = n["k3_by_op"]
        _check(not on_card or (
            by_op["blocks"] == 0 and by_op["combine"] == ops["combine"]
            and ops["expand"] <= by_op["expand"] <= ops["expand"] + min(
                k3.replayed - replayed, ops["combine"])),
            f"sim {name}: K3 launched {by_op}, its roles asked {dict(ops)}")
        held = {}
        for op, seeds, kw in k3_calls.calls:
            held.setdefault((op, len(seeds), kw["dimension"], kw["modulus"],
                             kw["prg"]), (op, seeds, kw))
        for call in held.values():
            k3_drill_err = max(k3_drill_err,
                               _k3_call_hold(f"sim {name}", *call))
        drill_rec[name] = {"exact": rec.get("exact"), "wall_s": wall,
                           "value": rec.get("value"), "k3": n["k3"],
                           "k3_calls": dict(ops), "k3_held": len(held)}
        if fleet is not None:
            drill_rec[name]["fleet"] = fleet
    # the tree drill's rounds mask with ChaCha seeds: K3 on a card
    _check(not on_card or drill_rec["tree"]["k3"] > 0,
           f"sim tree: K3 launched no time {drill_rec['tree']}")
    # the kernels at the shapes the runs launched them with, on the rows
    # and seeds each run drew
    pod = SimulatedPod(scheme, full, mesh=make_mesh(1, 1, devices=[dev]))

    def hold(case, rows_of, shape, seed, masked=True):
        return _sim_shard_hold(case, dev, pod, rows_of, shape, seed, masked)

    inputs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 20, size=(P, D), dtype=np.int64))
    # (a) the one shard, the round seed 0's tile (0, 0)
    k1_err = hold("sim pod shard", inputs, pod.padded_shape(P, D),
                  simpod._tile_seed(0, 0, 0))
    _empty_cache(dev)
    # (b) tile 0, keyed by the round seed's tile (0, 0); its ChaCha masks
    # are K3's, so K1 runs unmasked
    k1_err = max(k1_err, hold("sim streamed tile 0", inputs, (rows, width),
                              simpod._tile_seed(0, 0, 0), masked=False))
    _empty_cache(dev)
    # (g), (h): their one shard, the round seed 0's tile (0, 0)
    t_gh = time.perf_counter()
    for name, s_scheme in sim_schemes.items():
        s_pod = SimulatedPod(s_scheme, FullMasking(s_scheme.prime_modulus),
                             mesh=make_mesh(1, 1, devices=[dev]))
        k1_err = max(k1_err, _sim_shard_hold(
            f"sim {name} shard", dev, s_pod, inputs,
            s_pod.padded_shape(P, D), simpod._tile_seed(0, 0, 0)))
        _empty_cache(dev)
    gh_s += time.perf_counter() - t_gh
    print(f"  sim (g), (h): the runs and their holds in {gh_s:.1f} s")
    del inputs
    k3_err = max(_k3_window("sim streamed", dev, 0, p0, min(rows, P - p0),
                            0, width, p, out_dtype=torch.int32)
                 for p0 in sorted({0, (P - 1) // rows * rows}))
    # (d) the worker's last shard of the (8, 1) mesh: rank 0's rows
    # (default_rng(1000)), padded to 8 row shards, and its padding rows
    P_pad, d_pad = SimulatedPod(scheme, full, mesh=make_mesh(
        8, 1, devices=[dev] * 8)).padded_shape(-(-P // 8) * 8, D)
    P_loc = P_pad // 8
    local = torch.from_numpy(np.random.default_rng(1000).integers(
        0, 1 << 20, size=(P, D), dtype=np.int64))
    k1_err = max(k1_err, hold("sim multihost shard (7, 0)",
                              local[7 * P_loc:], (P_loc, d_pad),
                              simpod._tile_seed(0, 7, 0)))
    del local
    _empty_cache(dev)
    # (e) the last shard of the warm round's first tile: the device
    # provider's rows, the tile's seed, then the shard's
    ps, ds = drec["p_shards"], drec["d_shards"]
    Pc_loc = drec["participants_chunk"] // ps
    d_loc = drec["dim_tile"] // ds
    r0, c0 = (ps - 1) * Pc_loc, (ds - 1) * d_loc
    prov = synthetic_device_block_provider32(p, seed=drec["seed"],
                                             device=dev)
    k1_err = max(k1_err, hold(
        f"sim devscale shard ({ps - 1}, {ds - 1}) of tile 0",
        prov(r0, min(r0 + Pc_loc, drec["participants"]), c0,
             min(c0 + d_loc, drec["dim"])), (Pc_loc, d_loc),
        simpod._tile_seed(simpod._tile_seed(drec["seed"], 0, 0), ps - 1,
                          ds - 1)))
    _empty_cache(dev)
    seed_calls = _count_seed_words() - seed0
    _check(not on_card or seed_calls == 0,
           f"sim: the seed words derived on the host {seed_calls} times")
    return {"stage": "sim", "participants": P, "dim": D,
            "seed_word_calls": seed_calls,
            "participants_chunk": chunk, "streamed_tiles": tiles,
            "runs": runs, "launches": launches, "drills": drill_rec,
            "k1_launches": sum(n["k1"] for n in launches.values()),
            "k3_launches": sum(n["k3"] for n in launches.values()),
            "k3_launches_drills": sum(d["k3"] for d in drill_rec.values()),
            "k1_shard_max_abs_err": k1_err, "k3_window_max_abs_err": k3_err,
            "k3_drills_max_abs_err": k3_drill_err}


def _peak(dev):
    """The device-memory peak since the last call (None off the card)."""
    import torch

    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _empty_cache(dev):
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _k4_reset():
    from sda_tpu_torch.crypto import paillier_tpu

    k4 = paillier_tpu.montgomery_kernel
    k4.launches = 0
    k4.op_launches = dict.fromkeys(paillier_tpu.OPS, 0)
    return k4


def premix_phase(dev, ptxas_log, key_bits=K4_KEY_BITS, rows=K4_ROWS,
                 lanes=K4_LANES, P=P_PREMIX, B=B_PREMIX,
                 flagship_bits=PREMIX_KEY_BITS, shares=SHARES_PREMIX,
                 split_case=K4_SPLIT_CASE, wide_bits=WIDE_KEY_BITS,
                 wide_limbs=K4_WIDE_LIMBS, wide_rows=K4_WIDE_ROWS):
    """Phase 16: K4 against its plain version (on the same device) and
    Python ints, for ``mont_mul`` and the premix fold, at each key size and
    row count, and ``paillier_combine``'s device leg at each key size
    byte-identical to the host fold; the same checks of the wide instance
    on a random odd modulus of ``wide_limbs`` limbs; the flagship clerk column (P x B random units mod n^2,
    framed as participants' encryptions) through ``paillier_combine`` with
    ``SDA_PREMIX_DEVICE=1``, byte-identical to the host fold; a homomorphic
    check on real encryptions; K4's time (its launches alone, on the rows
    as ``to_limbs`` lays them out) beside its bound, the wrapper's
    (``premix_limbs``), the plain version's and the host fold's, and its
    time on a column of the same shape at a ``wide_bits`` key. Fails on a
    spill in any group instance. Returns the kernel's record."""
    import os

    import numpy as np
    import torch

    from sda_tpu_torch.benchmarks.bounds import k4_bound
    from sda_tpu_torch.crypto import encryption, paillier
    from sda_tpu_torch.crypto import paillier_tpu as pt
    from sda_tpu_torch.protocol import (Binary, Encryption, EncryptionKey,
                                        PackedPaillierEncryption)
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    on_card = dev.type == "cuda"
    instances = {}
    if on_card:
        info = sass.ptxas_info(ptxas_log)
        lib = pt._library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        groups = sorted({(int(g[1]), int(g[2])) for g in (
            re.search(r"montfoldILi(\d+)ELi(\d+)EE", key) for key in info)
            if g})
        for limbs in (32, 64, 128, 192):
            _check(pt.fold_shape(lib, limbs)[:2] in groups,
                   f"L={limbs} takes no group instance")
        for tpi, lpt in groups + [(1, 0)]:
            kernel = (f"montfoldILi{tpi}ELi{lpt}EE" if lpt
                      else "montfold_wide")
            ptx = next((v for key, v in info.items() if kernel in key), None)
            _check(ptx is not None, f"{kernel}: no ptxas line")
            # the smallest L of the instance's capacity picks it
            shape = pt.fold_shape(lib, tpi * lpt if lpt else 513)
            _check(shape[:2] == (tpi, lpt),
                   f"{kernel}: the C entry picks {shape[:2]}")
            warps = shape[3] * 128 // 32
            # the wide instance keeps its accumulator in device memory
            if lpt:
                _check(not sass.spills(ptx),
                       f"K4 {kernel} spills: {'; '.join(ptx)}")
            print(f"  K4 {kernel}: {'; '.join(ptx)}; resident warps an SM: "
                  f"{warps} (128-thread blocks, "
                  f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            instances[kernel] = {"ptxas": ptx, "resident_warps": warps}
    rng = np.random.default_rng(16)
    bad = 0

    def shape_of(limbs):
        """(threads a group, limbs a thread) of L's instance on the card"""
        return pt.fold_shape(lib, limbs)[:2] if on_card else "plain"

    def below(m, n):
        w = (m.bit_length() + 64) // 8
        raw = rng.bytes(w * n)
        return [int.from_bytes(raw[i * w:(i + 1) * w], "little") % m
                for i in range(n)]

    def limbs_on(ctx, vals, shape):
        return torch.from_numpy(ctx.to_limbs(vals)).reshape(
            *shape, ctx.L).to(dev)

    def equal(case, got, want):
        nonlocal bad
        got, want = got.cpu(), want.cpu()
        _check(got.shape == want.shape,
               f"{case}: {tuple(got.shape)} vs {tuple(want.shape)}")
        bad = max(bad, int((got != want).any(dim=-1).sum()))
        _check(torch.equal(got, want), f"{case}: kernel != plain version")

    def frames(pk, column, count):
        """[P][B] ciphertext ints -> P framed encryptions of ``count``
        shares each, as participants send them"""
        head = encryption.leb128(count) + encryption.leb128(1)
        encs = []
        for row in column:
            frame = [head]
            for c in row:
                raw = c.to_bytes((c.bit_length() + 7) // 8 or 1, "big")
                frame.append(encryption.leb128(len(raw)) + raw)
            encs.append(Encryption("PackedPaillier", Binary(b"".join(frame))))
        return encs

    def combine(ek, scheme, encs, on_device):
        os.environ["SDA_PREMIX_DEVICE"] = "1" if on_device else "0"
        try:
            return encryption.paillier_combine(ek, scheme, encs)
        finally:
            if old_env is None:
                os.environ.pop("SDA_PREMIX_DEVICE")
            else:
                os.environ["SDA_PREMIX_DEVICE"] = old_env

    def product(ctx, vals, P_):
        out = []
        for b in range(len(vals) // P_):
            acc = 1
            for p_ in range(P_):
                acc = acc * vals[p_ * (len(vals) // P_) + b] % ctx.modulus
            out.append(acc)
        return out

    def hold(ctx, label, rows_):
        """mont_mul at ``lanes`` lanes, the fold at each of ``rows_`` x
        ``lanes`` and the split path at ``split_case`` on ``ctx``'s
        modulus: equal to the plain version and to Python ints"""
        m = ctx.modulus
        r_inv = pow(1 << (32 * ctx.L), -1, m)
        a, b = below(m, lanes), below(m, lanes)
        a[:2], b[:2] = [m - 1, 1], [m - 1, m - 1]
        ta, tb = limbs_on(ctx, a, (lanes,)), limbs_on(ctx, b, (lanes,))
        got = ctx.mont_mul(ta, tb)
        equal(f"mont_mul {label}", got, pt.mont_mul_plain(ctx, ta, tb))
        _check(ctx.from_limbs(got) == [x * y * r_inv % m
                                       for x, y in zip(a, b)],
               f"mont_mul {label} != Python ints")
        for P_ in rows_:
            vals = below(m, P_ * lanes)
            for p_ in range(P_):  # lane 0 all m - 1, lane 1 all 1
                vals[p_ * lanes], vals[p_ * lanes + 1] = m - 1, 1
            x = limbs_on(ctx, vals, (P_, lanes))
            got = ctx.premix_limbs(x)
            fix = torch.from_numpy(ctx.fold_fix(P_)).to(dev)
            equal(f"premix {label} P={P_}", got, pt.premix_plain(ctx, x, fix))
            _check(ctx.from_limbs(got) == product(ctx, vals, P_),
                   f"premix {label} P={P_} != Python ints")
        # a small clerk: its lanes cannot fill the card, so the rows of a
        # lane are split among groups and a second launch folds them
        P_, B_ = split_case
        vals = below(m, P_ * B_)
        x = limbs_on(ctx, vals, (P_, B_))
        before = pt.montgomery_kernel.op_launches["partials"]
        got = ctx.premix_limbs(x)
        if on_card:
            _check(pt.montgomery_kernel.op_launches["partials"] > before,
                   f"premix {label} P={P_} x B={B_}: no split")
        equal(f"premix {label} P={P_} x B={B_} (split)", got,
              pt.premix_plain(ctx, x, torch.from_numpy(
                  ctx.fold_fix(P_)).to(dev)))
        _check(ctx.from_limbs(got) == product(ctx, vals, P_),
               f"premix {label} P={P_} x B={B_} != Python ints")

    old_env = os.environ.get("SDA_PREMIX_DEVICE")
    encryption.PREMIX_DEVICE = dev
    keys = {}
    for bits in key_bits:
        keys[bits] = paillier.keygen(bits)
        ctx = pt.MontgomeryContext(keys[bits][0].n_squared)
        m = ctx.modulus
        hold(ctx, f"{bits}-bit key", rows)
        # paillier_combine's device leg at this key: 8 x 16 random units
        # (128 modmuls, above the floor of 64)
        pk = keys[bits][0]
        scheme = PackedPaillierEncryption(1, 32, 16, bits)
        ek = EncryptionKey("PackedPaillier", Binary(pk.to_bytes()))
        encs = frames(pk, [below(m, 16) for _ in range(8)], 16)
        before = pt.montgomery_kernel.launches
        mixed = combine(ek, scheme, encs, True)
        if on_card:
            _check(pt.montgomery_kernel.launches > before,
                   f"paillier_combine at a {bits}-bit key missed K4")
        host = combine(ek, scheme, encs, False)
        bad = max(bad, int(mixed.value.data != host.value.data))
        _check(mixed.value.data == host.value.data,
               f"paillier_combine at a {bits}-bit key: device leg frames "
               f"differ from the host fold")
        print(f"  {bits}-bit key (m = n^2 of {m.bit_length()} bits, "
              f"L={ctx.L}, instance {shape_of(ctx.L)}): "
              f"mont_mul at B={lanes}, premix at P in {list(rows)} x "
              f"B={lanes} and the split path at P={split_case[0]} x "
              f"B={split_case[1]} equal to plain and Python ints; "
              f"paillier_combine of 8 x 16 on the device leg byte-identical "
              f"to the host fold")
    # the wide instance (L above the group instances'): no Paillier key
    # this size is made, so a random odd modulus of wide_limbs limbs
    big = (1 << (32 * wide_limbs - 16)) | (
        int.from_bytes(rng.bytes(4 * wide_limbs - 2), "little") | 1)
    ctx = pt.MontgomeryContext(big)
    _check(ctx.L == wide_limbs, f"wide modulus has {ctx.L} limbs")
    if on_card:
        _check(pt.fold_shape(lib, ctx.L)[1] == 0,
               f"L={ctx.L} does not take the wide instance")
    before = pt.montgomery_kernel.launches
    hold(ctx, f"{big.bit_length()}-bit modulus", wide_rows)
    if on_card:
        _check(pt.montgomery_kernel.launches > before,
               f"L={ctx.L} checks missed K4")
    print(f"  {big.bit_length()}-bit odd modulus (L={ctx.L}, instance "
          f"{shape_of(ctx.L)}): mont_mul at B={lanes}, premix at P in "
          f"{list(wide_rows)} x B={lanes} and the split path at "
          f"P={split_case[0]} x B={split_case[1]} equal to plain and Python "
          f"ints")
    checks = dict(pt.montgomery_kernel.op_launches)

    # the flagship clerk column, framed as the participants' encryptions
    pk, sk = keys.get(flagship_bits) or paillier.keygen(flagship_bits)
    n2 = pk.n_squared
    components = min(PREMIX_WINDOW, (flagship_bits - 1) // PREMIX_WINDOW)
    scheme = PackedPaillierEncryption(components, PREMIX_WINDOW,
                                      PREMIX_VALUE_BITS, flagship_bits)
    ek = EncryptionKey("PackedPaillier", Binary(pk.to_bytes()))
    count = min(shares, B * components)
    t0 = time.perf_counter()
    # random units mod n^2
    encs = frames(pk, [below(n2, B) for _ in range(P)], count)
    make_s = time.perf_counter() - t0
    k4 = _k4_reset()
    t0 = time.perf_counter()
    mixed = combine(ek, scheme, encs, True)
    combine_s = time.perf_counter() - t0
    launches = k4.launches
    by_op = dict(k4.op_launches)
    if on_card:
        _check(0 < launches <= 2 and by_op["fold"] == 1,
               f"the premix did not fold in one or two K4 launches: {by_op}")
    print(f"  paillier_combine (SDA_PREMIX_DEVICE=1) of P={P} x B={B} at a "
          f"{flagship_bits}-bit key: {combine_s:.3f} s wall; K4 launches "
          f"{by_op} (inputs made in {make_s:.3f} s)")

    # the same fold split into its host and device parts
    ctx = encryption._mont_ctx(n2)
    t0 = time.perf_counter()
    ints = [encryption._unframe_paillier(e.value.data)[2] for e in encs]
    unframe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_limbs = ctx.to_limbs([c for row in ints for c in row])
    to_limbs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.from_numpy(host_limbs).reshape(P, B, ctx.L).to(dev)
    if on_card:
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    fix = torch.from_numpy(ctx.fold_fix(P)).to(dev)
    # K4's time: its launches alone, on the rows as they are; the
    # wrapper's adds its checks and the output's allocation (the fix-up
    # constant is cached; the CPU rehearsal has no kernel to time alone)
    wrapper_ms = ms = median_ms(lambda: ctx.premix_limbs(x), dev)
    if on_card:
        ms = median_ms(lambda: pt._fold_launches(lib, stream, ctx, x, fix),
                       dev)
    got = ctx.premix_limbs(x)
    t0 = time.perf_counter()
    got_ints = ctx.from_limbs(got)
    from_limbs_s = time.perf_counter() - t0
    mixed_ints = encryption._unframe_paillier(mixed.value.data)[2]
    _check(got_ints == mixed_ints, "premix_limbs != paillier_combine")
    t0 = time.perf_counter()
    want = pt.premix_plain(ctx, x, fix)
    if on_card:
        torch.cuda.synchronize()
    plain_flagship_ms = (time.perf_counter() - t0) * 1e3
    equal(f"premix P={P} x B={B} vs plain", got, want)
    del want
    bound_ms, bound_by, detail = k4_bound(P * B, ctx.L, P, B)

    # the host fold over the whole column
    t0 = time.perf_counter()
    host = combine(ek, scheme, encs, False)
    host_ms = (time.perf_counter() - t0) * 1e3
    host_ints = encryption._unframe_paillier(host.value.data)[2]
    differ = sum(a != b for a, b in zip(host_ints, mixed_ints))
    _check(differ == 0 and host.value.data == mixed.value.data,
           f"device premix frames differ from the host fold ({differ} "
           f"lanes)")
    bad = max(bad, differ)

    # plain version at [16 x 256] on the flagship key
    x16 = x[:16, :256].contiguous()
    fix16 = torch.from_numpy(ctx.fold_fix(x16.shape[0])).to(dev)
    plain_ms = median_ms(lambda: pt.premix_plain(ctx, x16, fix16), dev,
                         reps=3, warmup=1)
    del x

    # the same column shape at a wide_bits key: random limbs below m (the
    # top limb below m's), every lane held to the plain version
    wctx = pt.MontgomeryContext(
        (keys.get(wide_bits) or paillier.keygen(wide_bits))[0].n_squared)
    words = rng.integers(0, 1 << 32, size=(P, B, wctx.L), dtype=np.uint32)
    words[..., -1] %= np.uint32(wctx.m_words[-1])
    xw = torch.from_numpy(words.view(np.int32)).to(dev)
    del words
    fixw = torch.from_numpy(wctx.fold_fix(P)).to(dev)
    k4w = _k4_reset()
    gotw = wctx.premix_limbs(xw)
    wide_launches = dict(k4w.op_launches)
    equal(f"premix P={P} x B={B} at a {wide_bits}-bit key", gotw,
          pt.premix_plain(wctx, xw, fixw))
    if on_card:
        ms_wide = median_ms(
            lambda: pt._fold_launches(lib, stream, wctx, xw, fixw), dev)
    else:
        ms_wide = median_ms(lambda: wctx.premix_limbs(xw), dev, reps=1,
                            warmup=0)
    bound_wide, _, detail_wide = k4_bound(P * B, wctx.L, P, B)
    del xw, gotw
    print(f"K4 premix at P={P} x B={B}, {wide_bits}-bit key (L={wctx.L}, "
          f"instance {shape_of(wctx.L)}): {ms_wide:.4f} "
          f"ms median of 20 (CUDA events, its launches {wide_launches}); "
          f"bound {bound_wide:.4f} ms ({detail_wide}); every lane equal to "
          f"plain")

    # homomorphic check: real encryptions of known packed vectors
    encryptor = encryption.PackedPaillierEncryptor(ek, scheme)
    vectors = rng.integers(0, 1 << PREMIX_VALUE_BITS,
                           size=(8, 4 * components))
    batches = [encryption._unframe_paillier(
        encryptor.encrypt(v).value.data)[2] for v in vectors]
    before = k4.launches
    sums = []
    for c in encryption._device_premix_rows(pk, batches):
        sums.extend(paillier.unpack(paillier.decrypt(sk, c), components,
                                    PREMIX_WINDOW))
    if on_card:
        _check(k4.launches > before, "the homomorphic check missed K4")
    _check(sums == vectors.sum(axis=0).tolist(),
           "homomorphic premix does not decrypt to the plaintext sums")
    print(f"  homomorphic check: 8 participants x 4 real encryptions at a "
          f"{flagship_bits}-bit key premixed through K4 decrypt to the "
          f"plaintext sums")
    print(f"K4 premix at P={P} x B={B} (L={ctx.L}): {ms:.4f} ms median of "
          f"20 (CUDA events; its launches on the [P, B, L] rows), the "
          f"wrapper (premix_limbs) {wrapper_ms:.4f} ms "
          f"({wrapper_ms / ms - 1:+.1%}); bound {bound_ms:.4f} "
          f"ms ({detail}); plain at the same shape {plain_flagship_ms:.1f} "
          f"ms (one call), at 16 x 256 {plain_ms:.3f} ms; host fold "
          f"{host_ms:.1f} ms (whole column, paillier_combine on the host); "
          f"host parts: unframe {unframe_s:.3f} s, to_limbs "
          f"{to_limbs_s:.3f} s, upload {upload_s:.3f} s, from_limbs "
          f"{from_limbs_s:.3f} s; paillier_combine {combine_s:.3f} s")
    encryption.PREMIX_DEVICE = None
    return {"launches": launches, "launches_by_op": by_op,
            "check_launches": checks, "instances": instances,
            "max_abs_err": bad, "ms": ms,
            "ms_of": f"K4's launches on the [P, B, L] rows, P={P} x B={B}, "
                     f"L={ctx.L}",
            "wrapper_ms": wrapper_ms,
            "wrapper_ms_of": "premix_limbs: the checks, the launches and "
                             "the output's allocation (fix-up cached)",
            "ms_wide": ms_wide, "bound_ms_wide": bound_wide,
            "ms_wide_of": f"P={P} x B={B}, {wide_bits}-bit key, "
                          f"L={wctx.L}",
            "launches_wide": wide_launches,
            "plain_ms": plain_ms, "plain_ms_of": "16 x 256",
            "plain_ms_flagship": plain_flagship_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "host_ms": host_ms,
            "host_of": "whole column, paillier_combine on the host",
            "combine_wall_s": combine_s, "unframe_s": unframe_s,
            "to_limbs_s": to_limbs_s, "upload_s": upload_s,
            "from_limbs_s": from_limbs_s}


def _round(service, dev, aggregation, inputs, clerks):
    """``tests/test_full_loop.py``'s flow through ``SdaClient``s on
    ``dev``; returns the revealed values."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore

    def client():
        keystore = MemoryKeystore()
        return SdaClient(SdaClient.new_agent(keystore), keystore, service,
                         device=dev)

    recipient = client()
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    aggregation = aggregation.replace(recipient=recipient.agent.id,
                                      recipient_key=key)
    recipient.upload_aggregation(aggregation)
    workers = [client() for _ in range(clerks)]
    for clerk in workers:
        clerk_key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk_key)
    recipient.begin_aggregation(aggregation.id)
    for x in inputs:
        participant = client()
        participant.upload_agent()
        participant.participate(x, aggregation.id)
    recipient.end_aggregation(aggregation.id)
    for worker in [recipient] + workers:
        worker.run_chores(-1)
    return recipient.reveal_aggregation(aggregation.id).positive().values


def _aggregation(dim, modulus, masking, sharing):
    from sda_tpu_torch.protocol import (Aggregation, AggregationId, AgentId,
                                        EncryptionKeyId, SodiumEncryption)

    return Aggregation(
        id=AggregationId.random(), title="chip smoke", vector_dimension=dim,
        modulus=modulus, recipient=AgentId.random(),
        recipient_key=EncryptionKeyId.random(), masking_scheme=masking,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption())


def host_crypto(reps=SEAL_REPS, sign_reps=SIGN_REPS, sizes=SEAL_SIZES,
                bundle=SEAL_BUNDLE):
    """The port's host crypto (``crypto/csrc/sodium.c``), built by the host
    compiler at first use: the known answers from libsodium reproduced,
    sealed-box round trips at ``sizes`` (and a tampered box refused), and
    the host's seal and open rate at ``bundle`` bytes and its sign and
    verify rate. Returns the JSON record."""
    import numpy as np

    from sda_tpu_torch.crypto import sodium

    t0 = time.perf_counter()
    sodium._load()
    build_s = time.perf_counter() - t0
    box_sk, seed = bytes(range(32)), bytes(range(32, 64))
    pk = sodium.box_public(box_sk)
    vk, sk = sodium.sign_seed_keypair(seed)
    sig = sodium.sign_detached(KAT_MESSAGE, sk)
    sealed = sodium.seal_with_ephemeral(KAT_MESSAGE, pk, bytes(range(64, 96)))
    for name, got, want in (("box_public", pk, KAT_BOX_PK),
                            ("sign_seed_keypair", vk, KAT_SIGN_PK),
                            ("sign_detached", sig, KAT_SIG),
                            ("seal_with_ephemeral", sealed, KAT_SEALED)):
        _check(got.hex() == want, f"host crypto: {name} != libsodium's")
    _check(sodium.seal_open(sealed, pk, box_sk) == KAT_MESSAGE,
           "host crypto: the known sealed box does not open")
    _check(sodium.verify_detached(sig, KAT_MESSAGE, vk)
           and not sodium.verify_detached(sig, KAT_MESSAGE + b"!", vk),
           "host crypto: verify of the known signature")
    rng = np.random.default_rng(12)
    rpk, rsk = sodium.box_keypair()
    for size in sizes:
        msg = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        box = sodium.seal(msg, rpk)
        _check(len(box) == size + sodium.SEAL_OVERHEAD
               and sodium.seal_open(box, rpk, rsk) == msg,
               f"host crypto: seal/open round trip at {size} B")
        flipped = bytearray(box)
        flipped[-1] ^= 1
        try:
            sodium.seal_open(bytes(flipped), rpk, rsk)
        except ValueError:
            continue
        _fail(f"host crypto: a tampered {size} B box opened")
    msg = rng.integers(0, 256, bundle, dtype=np.uint8).tobytes()
    box = sodium.seal(msg, rpk)

    def rate(fn, n):
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return n / (time.perf_counter() - t0)

    return {"stage": "host_crypto", "known_answers": True,
            "round_trip_bytes": list(sizes), "build_s": build_s,
            "bundle_bytes": bundle,
            "seal_MB_per_s": rate(lambda i: sodium.seal(msg, rpk), reps)
            * bundle / 1e6,
            "open_MB_per_s": rate(lambda i: sodium.seal_open(box, rpk, rsk),
                                  reps) * bundle / 1e6,
            "sign_per_s": rate(lambda i: sodium.sign_detached(
                msg[:64 + i], sk), sign_reps),
            "verify_per_s": rate(lambda i: sodium.verify_detached(
                sig, KAT_MESSAGE, vk), sign_reps)}


class K3Calls:
    """While entered, records the seeds, width, modulus and PRG of every
    mask expansion and combine a role asks of K3 (``chacha_device.
    expand_mask`` and ``combine_masks``) as (operation, seeds, keywords)."""

    def __enter__(self):
        from sda_tpu_torch.fields import chacha_device

        self.module, self.calls = chacha_device, []
        self._saved = expand, combine = (chacha_device.expand_mask,
                                         chacha_device.combine_masks)

        def expand_mask(seed, dimension, modulus, *, prg, device=None):
            self.calls.append(("expand", [list(seed)], dict(
                dimension=dimension, modulus=modulus, prg=prg,
                device=device)))
            return expand(seed, dimension, modulus, prg=prg, device=device)

        def combine_masks(seeds, dimension, modulus, *, prg, device=None):
            self.calls.append(("combine", [list(s) for s in seeds], dict(
                dimension=dimension, modulus=modulus, prg=prg,
                device=device)))
            return combine(seeds, dimension, modulus, prg=prg, device=device)

        chacha_device.expand_mask = expand_mask
        chacha_device.combine_masks = combine_masks
        return self

    def __exit__(self, *exc):
        self.module.expand_mask, self.module.combine_masks = self._saved


def _k3_call_hold(case, op, seeds, kw):
    """A K3 call of a round made again on the same seeds, width, modulus
    and PRG, held to the plain version with ``torch.equal``. Returns the
    max |error|."""
    import torch

    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.fields import chacha_device as cd

    words = cd._seed_matrix(seeds, resolve_device(kw["device"]))
    args = (kw["dimension"], kw["modulus"], kw["prg"])
    got = cd.chacha_kernel(op, words, dimension=args[0], modulus=args[1],
                           prg=args[2])[0]
    want = (cd.expand_plain(words, 0, *args) if op == "expand"
            else cd.combine_plain(words, *args))[0]
    _check(got.shape == want.shape,
           f"{case}: K3 {op} {tuple(got.shape)} vs {tuple(want.shape)}")
    equal = torch.equal(got, want)
    err = 0 if equal else int((got - want).abs().max())
    _check(equal, f"{case}: K3 {op} of {len(seeds)} seeds x {args[0]} != "
           f"plain (max |err| {err})")
    print(f"  {case}: K3 {op} of {len(seeds)} seeds x {args[0]} on the "
          "round's seeds: equal to plain")
    return err


def protocol_round(dev, P, D, seed=0, masking=None):
    """Phases 10 and 10b: one round over the in-process memory server at
    the flagship width, every role an ``SdaClient`` on ``dev``: one
    recipient, n clerks, P participants, with Full masks or the given
    ones. ChaCha masks go through K3 on a card (one expand a participant,
    the recipient's combine), which is held to its plain version on the
    seeds the round drew. Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch import utils
    from sda_tpu_torch.protocol import ChaChaMasking
    from sda_tpu_torch.server import new_memory_server

    scheme, full, p = _flagship()
    masking = masking or full
    seeded = isinstance(masking, ChaChaMasking)
    inputs = np.random.default_rng(seed).integers(0, 1 << 20, size=(P, D))
    utils.reset_phase_report()
    k3 = _k3_reset()
    with DeviceCounts() as counts, K3Calls() as k3_calls:
        t0 = time.perf_counter()
        out = _round(new_memory_server(), dev,
                     _aggregation(D, p, masking, scheme), inputs,
                     scheme.share_count)
        wall = time.perf_counter() - t0
    k3_launches = dict(k3.op_launches)
    _check(np.array_equal(out, inputs.sum(0) % p),
           "protocol round: reveal != column sum mod p")
    # a ChaCha masker adds and subtracts on the host
    calls = counts.check("protocol round", dev.type,
                         ROLE_OPS[:3] if seeded else ROLE_OPS[:5])
    rec = {"stage": "protocol_round_chacha" if seeded else "protocol_round",
           "run": True, "participants": P, "clerks": scheme.share_count,
           "dim": D, "masking": type(masking).__name__, "exact": True,
           "wall_s": wall, "elements_per_s": P * D / wall,
           "phases_s": _phases(utils), "device_calls": calls}
    if seeded:
        ops = collections.Counter(op for op, _, _ in k3_calls.calls)
        _check(dev.type != "cuda" or (
            ops["expand"] >= P and ops["combine"] == 1 and k3_launches
            == {"blocks": 0, "expand": ops["expand"], "combine": 1,
                "mask": 0}),
            f"protocol round (ChaCha): K3 calls {dict(ops)}, launches "
            f"{k3_launches}")
        # the first participant's expand and the recipient's combine
        held = [next(c for c in k3_calls.calls if c[0] == op)
                for op in ("expand", "combine") if ops[op]]
        rec["k3_launches"] = k3_launches
        rec["k3_max_abs_err"] = max(
            [_k3_call_hold("protocol round (ChaCha)", *c) for c in held],
            default=0)
    return rec


def http_round(dev, host_path_max):
    """Phase 11: the README walkthrough's round (additive sharing over 3
    clerks, mod 433, d=10, 3 participants) over the threaded HTTP server,
    with the sharing module's ``HOST_PATH_MAX`` set as given (0 sends even
    this round's algebra to ``dev``). Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch.crypto import sharing
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.protocol import AdditiveSharing, NoMasking
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.store import Filebased

    saved = sharing.HOST_PATH_MAX
    sharing.HOST_PATH_MAX = host_path_max
    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0")
    server.start_background()
    try:
        with tempfile.TemporaryDirectory() as tokens, \
                DeviceCounts() as counts:
            proxy = SdaHttpClient(server.address, store=Filebased(tokens))
            t0 = time.perf_counter()
            out = _round(proxy, dev, _aggregation(
                10, 433, NoMasking(), AdditiveSharing(3, 433)),
                WALKTHROUGH, 3)
            wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        sharing.HOST_PATH_MAX = saved
    want = [0, 2, 2, 4, 4, 6, 6, 8, 8, 10]
    _check(np.array_equal(out, want), f"HTTP round: reveal {out} != {want}")
    on_device = host_path_max == 0
    calls = counts.check(
        f"HTTP round (HOST_PATH_MAX={host_path_max})", dev.type,
        ("combine", "additive_share_from_randomness") if on_device else ())
    _check(on_device or not calls,
           f"HTTP round: device work below HOST_PATH_MAX: {calls}")
    return {"stage": "http_round", "run": True,
            "host_path_max": host_path_max, "reveal": [int(v) for v in out],
            "exact": True, "wall_s": wall, "device_calls": calls}


def premix_server_phase(dev, P=P_PREMIX_SERVER, D=D_PREMIX_SERVER,
                        scheme_args=PREMIX_SERVER_SCHEME, seed=0):
    """Phase 16b: the broker's Paillier premix inside a live server, the
    recipe of ``tests/test_torch_premix_server.py::
    test_premix_over_http_seam``: ``SdaHttpServer`` in this process over
    the memory server with ``premix_paillier`` (as ``sdad
    --premix-paillier`` sets it) and ``SDA_PREMIX_DEVICE=1`` with the
    premix on ``dev``, the size floor as shipped. A recipient (sealed-box
    key), 3 clerks with PackedPaillier keys of ``scheme_args`` and P
    participants of D values mod 433, every role an ``SdaClient`` on
    ``dev`` over HTTP; at the snapshot the server folds each clerk's column
    of P x ceil(D / components) ciphertexts through K4, which must launch
    on a card; every clerk job holds one premixed batch and the reveal is
    exact. K4 is then held to its plain version at the first column the
    server folded. Returns the phase's JSON record."""
    import os

    import numpy as np
    import torch

    from sda_tpu_torch import utils
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import encryption
    from sda_tpu_torch.crypto import paillier_tpu as pt
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.protocol import (AdditiveSharing, FullMasking,
                                        PackedPaillierEncryption,
                                        SodiumEncryption)
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.store import Filebased

    scheme = PackedPaillierEncryption(*scheme_args)
    B = -(-D // scheme.component_count)
    _check(P * B >= encryption._DEVICE_PREMIX_MIN_MODMULS,
           f"premix server: a column of {P} x {B} is below the size floor")
    inputs = np.random.default_rng(seed).integers(0, 433, size=(P, D))
    folds = []
    leg = encryption._device_premix_rows

    def recorded(pk, rows):
        folds.append((pk, rows))
        return leg(pk, rows)

    saved = (os.environ.get("SDA_PREMIX_DEVICE"), encryption.PREMIX_DEVICE)
    os.environ["SDA_PREMIX_DEVICE"] = "1"
    encryption.PREMIX_DEVICE = str(dev)
    encryption._device_premix_rows = recorded
    service = new_memory_server()
    service.server.premix_paillier = True
    httpd = SdaHttpServer(service, bind="127.0.0.1:0").start_background()
    utils.reset_phase_report()
    k4 = _k4_reset()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def client(name):
                ks = Filebased(Path(tmp) / name)
                return SdaClient(SdaClient.new_agent(ks), ks,
                                 SdaHttpClient(httpd.address, ks),
                                 device=dev)

            t0 = time.perf_counter()
            recipient = client("recipient")
            key = recipient.new_encryption_key()
            recipient.upload_agent()
            recipient.upload_encryption_key(key)
            aggregation = _aggregation(
                D, 433, FullMasking(433), AdditiveSharing(3, 433)).replace(
                recipient=recipient.agent.id, recipient_key=key,
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=scheme)
            recipient.upload_aggregation(aggregation)
            clerks = [client(f"clerk-{i}") for i in range(3)]
            for clerk in clerks:
                clerk.upload_agent()
                clerk.upload_encryption_key(clerk.new_encryption_key(scheme))
            recipient.begin_aggregation(aggregation.id)
            setup_s = time.perf_counter() - t0
            for i, x in enumerate(inputs):
                participant = client(f"p-{i}")
                participant.upload_agent()
                participant.participate([int(v) for v in x], aggregation.id)
            participate_s = time.perf_counter() - t0 - setup_s
            t1 = time.perf_counter()
            recipient.end_aggregation(aggregation.id)
            snapshot_s = time.perf_counter() - t1
            k4_launches, k4_by_op = k4.launches, dict(k4.op_launches)
            premixed = 0
            for member in clerks + [recipient]:
                job = service.get_clerking_job(member.agent, member.agent.id)
                if job is not None:
                    _check(len(job.encryptions) == 1,
                           f"premix server: a clerk job holds "
                           f"{len(job.encryptions)} batches, want 1")
                    premixed += 1
            _check(premixed == 3, f"premix server: {premixed} premixed jobs")
            for member in [recipient] + clerks:
                member.run_chores(-1)
            out = recipient.reveal_aggregation(aggregation.id)
            wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        encryption._device_premix_rows = leg
        encryption.PREMIX_DEVICE = saved[1]
        if saved[0] is None:
            os.environ.pop("SDA_PREMIX_DEVICE")
        else:
            os.environ["SDA_PREMIX_DEVICE"] = saved[0]
    _check(np.array_equal(out.positive().values, inputs.sum(0) % 433),
           "premix server: reveal != column sum mod 433")
    shapes = [(len(rows), len(rows[0])) for _, rows in folds]
    _check(shapes == [(P, B)] * 3, f"premix server: folds {shapes}")
    _check(dev.type != "cuda" or k4_launches > 0,
           "premix server: K4 never launched")
    # K4 at the first column the server folded, against its plain version
    pk, rows = folds[0]
    n2 = pk.n_squared
    ctx = pt.MontgomeryContext(n2)
    x = torch.from_numpy(ctx.to_limbs(
        [c % n2 for row in rows for c in row]).reshape(P, B, ctx.L)).to(dev)
    fix = torch.from_numpy(ctx.fold_fix(P)).to(dev)
    got, want = ctx.premix_limbs(x), pt.premix_plain(ctx, x, fix)
    equal = torch.equal(got, want)
    err = 0 if equal else int((got.to(torch.int64)
                               - want.to(torch.int64)).abs().max())
    _check(equal, f"premix server: K4 != plain at the folded column "
           f"[{P}, {B}, {ctx.L}] (max |err| {err})")
    print(f"  premix server: K4 at the folded column [{P}, {B}, {ctx.L}] "
          "equal to plain")
    return {"stage": "premix_server", "participants": P, "dim": D,
            "clerks": 3, "key_bits": scheme_args[3], "column": [P, B],
            "limbs": ctx.L, "exact": True, "premixed_jobs": premixed,
            "k4_launches": k4_launches, "k4_launches_by_op": k4_by_op,
            "k4_max_abs_err": err, "setup_s": setup_s,
            "participate_s": participate_s, "snapshot_s": snapshot_s,
            "wall_s": wall, "phases_s": _phases(utils)}


class Processes:
    """The port's ``sdad`` and ``sda`` run as a deployment runs them, each
    command a process of its own (``python -m <package>.cli.main
    --device <device>``) from this checkout, at most ``pool`` at once. With
    ``main`` given, ``sda`` commands go through ``main(argv)`` in this
    process instead, one at a time (the CPU twin's roles); ``popen`` and
    ``sdad`` always start processes. Every wait has a timeout, and a role
    that exits non-zero fails the phase. Records each process's wall."""

    def __init__(self, root, device, package="sda_tpu_torch", main=None,
                 env=None):
        import os

        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.package, self.main = package, main
        self.pool = DEPLOY_POOL if main is None else 1
        self.device = [] if device is None else ["--device", str(device)]
        here = str(Path(__file__).resolve().parent)
        self.cwd = here
        # the role processes share one bytecode cache: torch's modules are
        # compiled once, not in every process (its install may hold none)
        self.env = {**os.environ, "PYTHONPATH": here,
                    "PYTHONPYCACHEPREFIX": str(self.root / "pycache"),
                    **(env or {})}
        self.env.pop("PYTHONDONTWRITEBYTECODE", None)
        self.sdad_proc, self.url, self.walls = None, None, []

    def identity(self, who) -> Path:
        return self.root / "agents" / who

    def _argv(self, who, args, url=None):
        return [*self.device, "-s", url or self.url, "-i",
                str(self.identity(who)), *map(str, args)]

    def sda(self, who, *args, rc=0):
        """One ``sda`` command as ``who``; returns its stdout, stripped."""
        argv = self._argv(who, args)
        t0 = time.perf_counter()
        if self.main is not None:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                got = self.main(argv)
            out = out.getvalue()
        else:
            res = subprocess.run(
                [sys.executable, "-m", f"{self.package}.cli.main", *argv],
                cwd=self.cwd, env=self.env, capture_output=True, text=True,
                timeout=ROLE_TIMEOUT_S)
            got, out = res.returncode, res.stdout
            if got != rc:
                print(res.stderr[-4000:], file=sys.stderr)
        self.walls.append((args[0], time.perf_counter() - t0))
        _check(got == rc, f"sda {' '.join(map(str, args[:3]))} as {who}: "
               f"exit {got}, want {rc}")
        return out.strip()

    def popen(self, who, *args, url=None):
        """``sda`` as ``who`` in a process of its own, not waited for."""
        return subprocess.Popen(
            [sys.executable, "-m", f"{self.package}.cli.main",
             *self._argv(who, args, url)], cwd=self.cwd, env=self.env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def map(self, fn, items):
        items = list(items)
        if self.pool == 1:
            return [fn(item) for item in items]
        with ThreadPoolExecutor(min(self.pool, len(items))) as pool:
            return list(pool.map(fn, items))

    def start_sdad(self, *flags, port=0, env=None, sda_ping=True):
        """``sdad <flags> httpd`` on 127.0.0.1:``port`` (0: a free one);
        returns once it listens and answers ``sda ping`` (or, without
        ``sda_ping``, a ping from this process)."""
        import threading

        log = open(self.root / "sdad.log", "a")
        cmd = [sys.executable, "-m", f"{self.package}.cli.serverd",
               *self.device, *flags, "httpd", "--bind", f"127.0.0.1:{port}"]
        self.sdad_proc = proc = subprocess.Popen(
            cmd, cwd=self.cwd, env={**self.env, **(env or {})},
            stdout=subprocess.PIPE, stderr=log, text=True)
        log.close()
        lines = []
        # the first line is the address; the rest (the drain summary) is
        # read on as it comes, so the pipe never fills
        reader = threading.Thread(
            target=lambda: lines.extend(proc.stdout), daemon=True)
        reader.start()
        self._sdad_lines = lines
        deadline = time.monotonic() + ROLE_TIMEOUT_S
        while not lines and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        match = re.fullmatch(r"sdad listening on (\S+)\n",
                             lines[0] if lines else "")
        if match is None:
            proc.kill()
            proc.wait(timeout=60)
            _fail(f"sdad did not start: {lines[:1]}; log: "
                  f"{(self.root / 'sdad.log').read_text()[-4000:]}")
        self.url = match[1]
        if sda_ping:
            _check(self.sda("ping", "ping") == '{"running": true}',
                   "sda ping: sdad not running")
        else:
            from sda_tpu_torch.http import SdaHttpClient

            _check(SdaHttpClient(self.url).ping().running,
                   "ping: sdad not running")
        return self.url

    def kill_sdad(self):
        """SIGKILL: the server process dies with no drain."""
        self.sdad_proc.kill()
        self.sdad_proc.wait(timeout=60)
        self.sdad_proc = None

    def stop_sdad(self):
        """SIGTERM: the daemon drains and prints its summary last."""
        proc = self.sdad_proc
        proc.terminate()
        rc = proc.wait(timeout=120)
        self.sdad_proc = None
        time.sleep(0.1)  # the reader thread takes the last line
        last = self._sdad_lines[-1] if self._sdad_lines else ""
        _check(rc == 0 and last.startswith("sdad drained {"),
               f"sdad exited {rc} after SIGTERM: {last!r}")
        return json.loads(last[len("sdad drained "):])

    def close(self):
        if self.sdad_proc is not None:
            self.sdad_proc.kill()
            self.sdad_proc.wait(timeout=60)
            self.sdad_proc = None


class _Gate:
    """A TCP relay on 127.0.0.1 to ``target`` ("http://host:port") that
    drops a connection instead of relaying its client's bytes once
    ``closed()`` is true: the process behind it can talk to the server
    until then, and nothing it sends afterwards lands."""

    def __init__(self, target, closed):
        import socket
        import threading

        host, port = target.rsplit("//", 1)[1].rsplit(":", 1)
        self.target, self.closed = (host, int(port)), closed
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        self._socket, self._threading = socket, threading
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
                up = self._socket.create_connection(self.target)
            except OSError:
                return
            for src, dst, gated in ((conn, up, True), (up, conn, False)):
                self._threading.Thread(target=self._pipe,
                                       args=(src, dst, gated),
                                       daemon=True).start()

    def _pipe(self, src, dst, gated):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data or (gated and self.closed()):
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(self._socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self.sock.close()


def _journal_entries(directory):
    return [p for p in Path(directory).glob("*.json")
            if not p.name.startswith(".")]


def _viewer(roles, dev):
    """The recipient's identity opened in this process (the port's
    ``sda`` client), for the phase's own reads of the round."""
    from argparse import Namespace

    from sda_tpu_torch.cli.main import load_client

    return load_client(Namespace(identity=str(roles.identity("recipient")),
                                 server=roles.url, device=str(dev)))


def _status(viewer, agg):
    """The aggregation's status as ``sda aggregations status`` prints it."""
    from sda_tpu_torch.protocol import AggregationId

    return viewer.service.get_aggregation_status(
        viewer.agent, AggregationId(agg)).to_obj()


def _stored_digest(db, agg, participant):
    """The digest of the participation the server's sqlite file holds for
    ``participant`` in ``agg``, or None; read-only."""
    import sqlite3

    conn = sqlite3.connect(f"file:{db}?mode=ro", uri=True, timeout=60)
    try:
        row = conn.execute(
            "SELECT digest FROM participations WHERE aggregation = ? AND "
            "participant = ?", (agg, participant)).fetchone()
    finally:
        conn.close()
    return row and row[0]


def _step(steps, name, t0, smi):
    steps[name] = time.perf_counter() - t0
    print(f"  deployment {name}: {steps[name]:.2f} s ({smi})", flush=True)


def _walls(roles, command):
    walls = sorted(w for c, w in roles.walls if c == command)
    return {"n": len(walls), "min_s": walls[0],
            "median_s": statistics.median(walls), "max_s": walls[-1]}


def deployment_phase(dev, smi="", P=P_DEPLOY, D=D_DEPLOY, root=None,
                     main=None):
    """Phase 23 (a): the deployment as processes, every ``sda`` and
    ``sdad`` on ``dev``. ``sdad`` over a sqlite file; a recipient, 8
    clerks and P participants (identities made concurrently); a ChaCha
    aggregation of width D mod M shared by packed Shamir k=3 over the
    CLI's NTT prime, its committee the 8 clerks; each participant sends a
    float64 update from a ``.npy`` file (``participate --model --journal``:
    its fixed-point encode, its mask expand on K3 on a card, its packed
    shares, its sealed boxes). Participant 0 talks to ``sdad`` through a
    ``_Gate`` that closes once its journal entry exists, so its upload
    cannot land; its process is SIGKILLed then, and ``sda resume``
    re-uploads the journaled bundle; ``sdad`` is SIGKILLed after every
    participation landed and restarted on the same file and port; clerk
    ``absent`` never runs, the other 7 and the recipient run ``clerk
    --once``; ``reveal --fixed-point-bits --mean`` must equal, bit for bit,
    the mean decoded from the updates' own encodes. Then the recipient's
    mask seeds, opened in this process with its keystore, hold K3's
    combine and one expand to the plain version. With ``main``, the roles
    but participant 0's crash run in this process (the CPU twin). The
    files stay in ``root`` when given. Returns the phase's JSON record."""
    import numpy as np

    from sda_tpu_torch.client.journal import ParticipationJournal
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.models import FixedPointCodec
    from sda_tpu_torch.protocol import AggregationId, SnapshotId
    from sda_tpu_torch.server import new_sqlite_server

    M, clerks, absent, bits = M_DEPLOY, DEPLOY_CLERKS, DEPLOY_ABSENT, \
        DEPLOY_BITS
    steps = {}
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory())
        root = Path(root)
        roles = Processes(root / "round", dev, main=main)
        stack.callback(roles.close)
        db = root / "round" / "sda.db"
        t_phase = t0 = time.perf_counter()
        roles.start_sdad("--sqlite", db)
        port = int(roles.url.rsplit(":", 1)[1])
        _step(steps, "sdad start", t0, smi)

        t0 = time.perf_counter()
        names_clerks = [f"clerk-{i}" for i in range(clerks)]
        names_parts = [f"p-{i}" for i in range(P)]

        def identity(who):
            agent = roles.sda(who, "agent", "create")
            if who not in names_parts:
                roles.sda(who, "agent", "keys", "create")
            return agent

        names = ["recipient", *names_clerks, *names_parts]
        ids = dict(zip(names, roles.map(identity, names)))
        _step(steps, "identities", t0, smi)
        start_up = _walls(roles, "agent")
        print(f"  deployment: {start_up['n']} identity processes, at most "
              f"{roles.pool} at once, {start_up['min_s']:.2f} / "
              f"{start_up['median_s']:.2f} / {start_up['max_s']:.2f} s "
              f"(min / median / max) each, start-up included ({smi})")

        t0 = time.perf_counter()
        agg = roles.sda("recipient", "aggregations", "create", "deployment",
                        "--dimension", D, "--modulus", M, "--mask", "chacha",
                        "--sharing", "shamir", "--shares", clerks,
                        "--secrets-per-batch", 3)
        viewer = _viewer(roles, dev)
        roles.sda("recipient", "aggregations", "begin", agg,
                  *[x for c in names_clerks for x in ("--clerk", ids[c])])
        _step(steps, "create and begin", t0, smi)

        updates = [np.random.default_rng(DEPLOY_SEED + i).normal(0, 1e-2, D)
                   for i in range(P)]
        files = [root / f"update-{i}.npy" for i in range(P)]
        for f, u in zip(files, updates):
            np.save(f, u)

        def participate(i):
            return roles.sda(f"p-{i}", "participate", agg, "--model",
                             files[i], "--journal", "--max-summands", P)

        crash = {}

        def crash_and_resume(_):
            """Participant 0 killed once its journal entry exists, then
            ``sda resume``."""
            journal = roles.identity("p-0") / "journal"
            t1 = time.perf_counter()
            gate = _Gate(roles.url, lambda: bool(_journal_entries(journal)))
            try:
                proc = roles.popen("p-0", "participate", agg, "--model",
                                   files[0], "--journal", "--max-summands",
                                   P, url=gate.url)
                deadline = time.monotonic() + ROLE_TIMEOUT_S
                while not _journal_entries(journal):
                    _check(proc.poll() is None,
                           f"participant 0 exited {proc.returncode} before "
                           "its journal entry was seen")
                    _check(time.monotonic() < deadline,
                           "participant 0: no journal entry in time")
                    time.sleep(0.002)
                proc.kill()
                proc.wait(timeout=60)
            finally:
                gate.close()
            crash["journal_s"] = time.perf_counter() - t1
            [entry] = ParticipationJournal(journal).pending()
            crash["digest"] = entry.canonical_digest()
            _check(_stored_digest(db, agg, ids["p-0"]) is None,
                   "participant 0's upload landed past the closed gate")
            t1 = time.perf_counter()
            out = roles.sda("p-0", "resume")
            crash["resume_s"] = time.perf_counter() - t1
            _check(out == "resumed 1 of 1 journaled participation(s); 0 "
                   "still pending", f"sda resume: {out!r}")
            _check(not _journal_entries(journal),
                   "participant 0's journal entry not reaped")

        t0 = time.perf_counter()
        roles.map(lambda i: crash_and_resume(i) if i == 0 else
                  participate(i), range(P))
        # each participant counts at most once (the server's exactly-once
        # key), so P in all means participant 0 counted exactly once
        counted = _status(viewer, agg)["number_of_participations"]
        _check(counted == P, f"{counted} participations, want {P}")
        _step(steps, "participations", t0, smi)
        for i in range(1, P):
            _check(not _journal_entries(roles.identity(f"p-{i}") / "journal"),
                   f"participant {i}'s journal entry not reaped")

        # sdad dies between the participations and the snapshot
        t0 = time.perf_counter()
        roles.kill_sdad()
        roles.start_sdad("--sqlite", db, port=port, sda_ping=False)
        _step(steps, "sdad kill and restart", t0, smi)
        status = _status(viewer, agg)
        _check(status["number_of_participations"] == P,
               f"after the restart: {status['number_of_participations']} "
               f"participations, want {P}")
        t0 = time.perf_counter()
        roles.sda("recipient", "aggregations", "end", agg)
        _step(steps, "end (snapshot)", t0, smi)

        # the bundle the server froze for participant 0 is the journaled one
        store = new_sqlite_server(db)
        try:
            snap = _status(viewer, agg)["snapshots"][0]["id"]
            frozen = {str(p.participant): p.canonical_digest() for p in
                      store.server.aggregation_store.
                      iter_snapped_participations(AggregationId(agg),
                                                  SnapshotId(snap))}
        finally:
            store.server.agents_store.db.conn.close()
        _check(len(frozen) == P and frozen.get(ids["p-0"]) == crash["digest"],
               "the snapshot does not hold participant 0's journaled bundle")

        t0 = time.perf_counter()
        present = [c for i, c in enumerate(names_clerks) if i != absent]
        roles.map(lambda c: roles.sda(c, "clerk", "--once"), present)
        roles.sda("recipient", "clerk", "--once")
        _step(steps, "clerks", t0, smi)
        snap = _status(viewer, agg)["snapshots"][0]
        _check(snap["number_of_clerking_results"] == clerks - 1
               and snap["result_ready"], f"snapshot after the clerks: {snap}")

        t0 = time.perf_counter()
        out = roles.sda("recipient", "aggregations", "reveal", agg,
                        "--fixed-point-bits", bits, "--mean")
        got = np.array(out.split(), dtype=np.float64)
        _step(steps, "reveal", t0, smi)

        # the oracle: each update encoded as `participate --model` does,
        # summed mod M, the mean decoded as `reveal --mean` does
        codec = FixedPointCodec(M, bits, P)
        total = np.zeros(D, dtype=np.int64)
        for u in updates:
            total = (total + codec.encode(u)) % M
        want = codec.decode_mean(total, P)
        _check(got.shape == want.shape, f"reveal: {got.shape} floats")
        err = float(np.abs(got - want).max())
        _check(np.array_equal(got, want),
               f"reveal != the oracle's mean (max |err| {err})")
        quant = float(np.abs(got - np.mean(updates, axis=0)).max())

        # K3 on the round's own seeds: the recipient's, opened here
        t0 = time.perf_counter()
        client = viewer
        aggregation = client.service.get_aggregation(client.agent,
                                                     AggregationId(agg))
        # the CLI's packed Shamir: k=3 over the generator's NTT prime
        sharing = aggregation.committee_sharing_scheme
        t, prime, _, _ = numtheory.generate_packed_params(
            3, clerks, min(M.bit_length() + 21, 28))
        _check((sharing.secret_count, sharing.privacy_threshold,
                sharing.prime_modulus) == (3, t, prime),
               f"the CLI's sharing: {sharing.to_obj()}")
        result = client.service.get_snapshot_result(
            client.agent, aggregation.id,
            client.service.get_aggregation_status(
                client.agent, aggregation.id).snapshots[0].id)
        decryptor = client.crypto.new_share_decryptor(
            aggregation.recipient_key,
            aggregation.recipient_encryption_scheme)
        seeds = [[int(w) for w in decryptor.decrypt(e)]
                 for e in result.recipient_encryptions]
        _check(len(seeds) == P, f"{len(seeds)} mask seeds, want {P}")
        kw = dict(dimension=D, modulus=M, prg=aggregation.masking_scheme.prg,
                  device=str(dev))
        k3_err = max(_k3_call_hold("deployment", "combine", seeds, kw),
                     _k3_call_hold("deployment", "expand", seeds[:1], kw))
        _step(steps, "K3 hold on the round's seeds", t0, smi)
        drained = roles.stop_sdad()
        steps["phase"] = time.perf_counter() - t_phase
    return {"stage": "deployment", "participants": P, "dim": D,
            "modulus": M, "prime": sharing.prime_modulus, "clerks": clerks,
            "absent_clerk": absent, "fixed_point_bits": bits,
            "exact": True, "max_abs_err": err,
            "mean_sha256": hashlib.sha256(got.tobytes()).hexdigest(),
            "max_abs_err_vs_float_mean": quant, "steps_s": steps,
            "participant_0": {k: v for k, v in crash.items()
                              if k != "digest"},
            "start_up_s": start_up,
            "participate_s": _walls(roles, "participate"),
            "clerk_s": _walls(roles, "clerk"),
            "k3_max_abs_err": k3_err, "sdad_drained": drained}


def paillier_deployment_phase(dev, smi="", P=P_DEPLOY_PAILLIER,
                              D=D_DEPLOY_PAILLIER,
                              key_bits=DEPLOY_PAILLIER_BITS, main=None):
    """Phase 23 (b): the Paillier leg as processes. ``sdad --premix-paillier
    --metrics --sqlite`` on ``dev`` with ``SDA_PREMIX_DEVICE=1``; a
    recipient and 3 clerks with PackedPaillier keys of ``key_bits``; an
    additive aggregation of P x D values mod 433 with Full masks and
    ``--encryption paillier``, its committee the 3 clerks. At ``end`` the
    server premixes each clerk's column (K4 on a card); its ``/metrics``
    must count the columns, and the reveal must equal the int64 column sum
    mod 433 (a wrong K4 product decrypts to a wrong sum). Returns the
    phase's JSON record."""
    import urllib.request

    import numpy as np

    steps = {}
    inputs = np.random.default_rng(0).integers(0, 433, size=(P, D))
    with contextlib.ExitStack() as stack:
        root = Path(stack.enter_context(tempfile.TemporaryDirectory()))
        roles = Processes(root, dev, main=main)
        stack.callback(roles.close)
        t_phase = t0 = time.perf_counter()
        roles.start_sdad("--premix-paillier", "--metrics", "--statusz",
                         "--sqlite", root / "sda.db",
                         env={"SDA_PREMIX_DEVICE": "1"}, sda_ping=False)
        _step(steps, "paillier sdad start", t0, smi)
        t0 = time.perf_counter()
        names_clerks = [f"clerk-{i}" for i in range(3)]

        def identity(who):
            agent = roles.sda(who, "agent", "create")
            roles.sda(who, "agent", "keys", "create", "--encryption",
                      "paillier", "--paillier-modulus-bits", key_bits)
            return agent

        # participants register with their first participation
        names = ["recipient", *names_clerks]
        ids = dict(zip(names, roles.map(identity, names)))
        agg = roles.sda("recipient", "aggregations", "create", "premixed",
                        "--dimension", D, "--modulus", 433, "--shares", 3,
                        "--mask", "full", "--encryption", "paillier",
                        "--paillier-modulus-bits", key_bits)
        roles.sda("recipient", "aggregations", "begin", agg,
                  *[x for c in names_clerks for x in ("--clerk", ids[c])])
        _step(steps, "paillier identities, create and begin", t0, smi)
        t0 = time.perf_counter()
        roles.map(lambda i: roles.sda(f"p-{i}", "participate", agg,
                                      *inputs[i]), range(P))
        _step(steps, "paillier participations", t0, smi)
        t0 = time.perf_counter()
        roles.sda("recipient", "aggregations", "end", agg)
        _step(steps, "paillier end (snapshot, premix)", t0, smi)
        with urllib.request.urlopen(f"{roles.url}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(f"{roles.url}/statusz", timeout=60) as r:
            statusz = json.loads(r.read().decode())
        premix = {name: int(value) for name, value in re.findall(
            r'^sda_events_total\{name="server\.premix\.(\w+)"\} (\d+)$',
            metrics, re.MULTILINE)}
        _check(premix.get("inputs") == P * 3 and premix.get("outputs", 0) > 0,
               f"sdad premixed {premix}, want {P * 3} inputs")
        t0 = time.perf_counter()
        roles.map(lambda c: roles.sda(c, "clerk", "--once"),
                  [*names_clerks, "recipient"])
        out = roles.sda("recipient", "aggregations", "reveal", agg)
        _step(steps, "paillier clerks and reveal", t0, smi)
        want = inputs.sum(axis=0) % 433
        got = np.array(out.split(), dtype=np.int64)
        _check(np.array_equal(got, want),
               "paillier deployment: reveal != column sum mod 433")
        roles.stop_sdad()
        steps["phase"] = time.perf_counter() - t_phase
    return {"stage": "deployment_paillier", "participants": P, "dim": D,
            "clerks": 3, "key_bits": key_bits, "exact": True,
            "max_abs_err": 0, "premix_counters": premix,
            "statusz_store": statusz.get("store"), "steps_s": steps}


_CHAOS_SEED = ["--chaos-seed", "20260803", "--chaos-rate", "0.05"]
_CHURN = ["--chaos", "--churn", "0.35", "--chaos-store", "sqlite",
          *_CHAOS_SEED]
_CODEC = ["--load", "--participants", "16", "--dim", "64",
          "--load-arrivals", "closed", "--load-concurrency", "4",
          "--load-seed", "20260803", "--load-store", "memory",
          "--load-codec"]
_POISON = ["--fl", "--participants", "5", "--fl-rounds", "2",
           "--fl-seed", "3"]
#: the device perf plane's round (``ci.sh:688``)
P_PERF, D_PERF = 16, 96
_PERF = ["--participants", str(P_PERF), "--dim", str(D_PERF), "--clerks",
         "8", "--verify"]
#: ``ci.sh``'s sections that phase 24 runs through the port's ``sda-sim``:
#: each leg's arguments as ``ci.sh`` passes them (``--device`` is added;
#: ``{tmp}`` is the section's scratch directory and ``{connections}`` the
#: storm's count, ``ci.sh``'s 10,000 on the card)
CI_LEGS = {
    "dead_clerk": {
        "shamir": ["--chaos", "--dead-clerks", "1", *_CHAOS_SEED],
        "additive": ["--chaos", "--dead-clerks", "1", "--chaos-sharing",
                     "additive", *_CHAOS_SEED]},
    "brownout": {"brownout": ["--chaos", "--brownout", "1.0",
                              *_CHAOS_SEED]},
    "churn": {"threaded": _CHURN, "async": [*_CHURN, "--async-http"]},
    "storm": {"storm": ["--connstorm", "{connections}", "--connstorm-waves",
                        "2", "--connstorm-rss-limit", "1024"]},
    "codec": {"json": [*_CODEC, "json"], "bin": [*_CODEC, "bin"]},
    "poison": {
        "clean": _POISON,
        "undefended": [*_POISON, "--poison", "0.4"],
        "defended": [*_POISON, "--poison", "0.4", "--fl-norm-clip", "0.5"],
        "tree": ["--fl", "--participants", "9", "--fl-rounds", "2",
                 "--fl-seed", "5", "--fl-tree-group", "3", "--poison",
                 "0.25", "--poison-kind", "signflip", "--fl-tree-robust"]},
    "trace": {"trace": ["--load", "--participants", "12", "--dim", "4",
                        "--load-arrivals", "closed", "--load-concurrency",
                        "4", "--load-seed", "20260803", "--load-store",
                        "memory", "--trace-out", "{tmp}/trace.json"]},
    "perf": {"plain": _PERF, "pallas": [*_PERF, "--pallas"]},
}
#: the recorder overhead bench, run as ``ci.sh`` runs it (its module)
RECORDER_BENCH = ["--spans", "20000", "--max-overhead-pct", "400"]
CI_SECTIONS = (*CI_LEGS, "recorder")
STORM_CONNECTIONS = 10_000


def _gate(tool, record=None):
    """``ci.sh``'s advisory gate through the port: ``obs.regress
    --advisory`` (``tool="regress"``) or ``sda-bench --check --advisory``
    (``"bench"``) over the committed ``BENCH_r*.json`` and, when given,
    ``record`` tagged ``framework: torch``. It must exit 0."""
    from sda_tpu_torch.cli import bench as sda_bench
    from sda_tpu_torch.obs import regress

    paths = sorted(str(f) for f in
                   Path(__file__).resolve().parent.glob("BENCH_r*.json"))
    with tempfile.TemporaryDirectory() as tmp:
        if record is not None:
            path = Path(tmp) / "record.json"
            path.write_text(json.dumps({**record, "framework": "torch"}))
            paths.append(str(path))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = (regress.main(["--advisory", *paths]) if tool == "regress"
                  else sda_bench.main(["--check", "--advisory", *paths]))
    _check(rc == 0, f"the advisory gate ({tool}) exited {rc}")


def _ci_dead_clerk(legs, dev, tmp):
    """``ci.sh:45-67``: Shamir degrades and reveals bit-exactly without
    the dead clerk; additive fails closed, typed, before the deadline."""
    shamir, additive = legs["shamir"], legs["additive"]
    states = [s for s, _ in shamir["round_history"]]
    _check(shamir["exact"] is True, f"dead clerk, shamir: {shamir}")
    _check("degraded" in states and states[-1] == "revealed",
           f"dead clerk, shamir: states {states}")
    _check(bool(shamir["round_dead_clerks"]) and bool(
        shamir["time_to_degraded_s"]) and shamir["time_to_degraded_s"] > 0,
        f"dead clerk, shamir: {shamir}")
    _check(additive["round_state"] == "failed" and bool(
        additive["round_reason"]), f"dead clerk, additive: {additive}")
    _check(bool(additive["failure"])
           and additive["failure"]["type"] == "RoundFailed",
           f"dead clerk, additive: failure {additive['failure']}")
    _check(bool(additive["time_to_failed_s"])
           and additive["time_to_failed_s"] > 0,
           f"dead clerk, additive: {additive}")
    _gate("regress", {
        "metric": "time to degraded (dead-clerk drill, 8-clerk packed "
                  "Shamir over HTTP)",
        "value": shamir["time_to_degraded_s"], "unit": "seconds",
        "platform": dev.type, "seed": shamir["seed"],
        "clerking_deadline_s": 1.5})
    return {"states": states,
            "time_to_degraded_s": shamir["time_to_degraded_s"],
            "additive_state": additive["round_state"],
            "time_to_failed_s": additive["time_to_failed_s"]}


def _ci_brownout(legs, dev, tmp):
    """``ci.sh:83-111``: the round survives a second of store failures
    bit-exactly; the breaker opened, shed with 503s and closed again."""
    report = legs["brownout"]
    _check(report["ready"] and report["exact"], f"brownout: {report}")
    breaker, counters = report["breaker"], report["counters"]
    _check(breaker["times_opened"] >= 1 and breaker["state"] == "closed",
           f"brownout: breaker {breaker}")
    _check(counters.get("server.store.breaker.shed", 0) >= 1
           and counters.get("http.status.503", 0) >= 1,
           f"brownout: counters {counters}")
    mttr = report["time_to_recover_s"]
    _check(bool(mttr) and 0 < mttr < 10.0, f"brownout: {report}")
    _gate("regress", {
        "metric": "time to recover (store brownout drill, 1s window, "
                  "breaker threshold 3)",
        "value": mttr, "unit": "seconds", "platform": dev.type,
        "seed": report["seed"], "brownout_s": report["brownout_s"],
        "breaker_recovery_s": breaker["recovery_s"]})
    return {"time_to_recover_s": mttr,
            "times_opened": breaker["times_opened"],
            "shed": counters.get("server.store.breaker.shed")}


def _ci_churn(legs, dev, tmp):
    """``ci.sh:125-149``, the churn drill's exactly-once verdict on the
    threaded plane; ``ci.sh:162-173``, the async plane's A/B: the same
    verdicts and ``server.participation.*`` counters on both planes."""
    threaded, asyncp = legs["threaded"], legs["async"]
    _check(threaded["exact"] is True
           and threaded["participants_churned"] >= 1
           and threaded["participants_resumed"]
           == threaded["participants_churned"]
           and threaded["participations_replayed"] >= 1
           and threaded["equivocations_undetected"] == 0
           and threaded["equivocations_detected"] >= 1
           and threaded["double_counted"] == 0, f"churn: {threaded}")
    _gate("regress", {
        "metric": "churn drill resume wall (12 participants, ~40% churn, "
                  "journal resume over HTTP)",
        "value": threaded["time_to_resume_s"], "unit": "seconds",
        "platform": dev.type, "seed": threaded["seed"],
        "churn_rate": threaded["churn_rate"],
        "participants_resumed": threaded["participants_resumed"]})
    _check(threaded["http_plane"] == "threaded"
           and asyncp["http_plane"] == "async",
           f"churn A/B: planes {threaded['http_plane']}, "
           f"{asyncp['http_plane']}")
    for key in ("exact", "ready", "participants_churned",
                "participants_resumed", "participations_replayed",
                "equivocations_detected", "equivocations_undetected",
                "double_counted", "admitted_participations"):
        _check(threaded[key] == asyncp[key],
               f"churn A/B: {key} {threaded[key]} vs {asyncp[key]}")

    def part(rep):
        return {k: v for k, v in rep["counters"].items()
                if k.startswith("server.participation.")}

    _check(part(threaded) == part(asyncp),
           f"churn A/B: {part(threaded)} vs {part(asyncp)}")
    return {"participants_churned": threaded["participants_churned"],
            "participants_resumed": threaded["participants_resumed"],
            "time_to_resume_s": threaded["time_to_resume_s"],
            "participation_counters": part(asyncp)}


def _ci_storm(legs, dev, tmp):
    """``ci.sh:215-232``: every connection held and served on every wave,
    no 5xx, no transport or connect failure, a clean drain, and the
    worker's memory under 1024 MiB."""
    record = legs["storm"]
    _check(record["ok"] is True, f"storm: {record}")
    _check(record["errors_5xx"] == 0, f"storm: {record['statuses']}")
    _check(record["transport_failures"] == 0
           and record["connect_failures"] == 0, f"storm: {record}")
    _check(record["leaked"] == 0, f"storm: drain {record['drain']}")
    _check(record["clamped_by_fd_limit"]
           or record["value"] == record["requested_connections"],
           f"storm: {record['value']} of {record['requested_connections']}"
           " connections")
    _check(record["rss_bounded"] is True, f"storm: {record}")
    print(f"  storm: {record['value']} connections held (fd soft limit "
          f"{record['fd_soft_limit']}, clamped "
          f"{record['clamped_by_fd_limit']}); sdad RSS "
          f"{record['rss_baseline_mb']} -> {record['rss_mb']} MiB "
          f"({record['per_connection_kb']} KiB a connection), bound "
          f"{record['rss_limit_mb']} MiB")
    _gate("bench", record)
    return {key: record[key] for key in (
        "value", "clamped_by_fd_limit", "fd_soft_limit", "rss_baseline_mb",
        "rss_mb", "per_connection_kb", "rss_limit_mb", "rss_bounded",
        "errors_5xx", "leaked", "connect_s", "drain_wall_s")}


def _ci_codec(legs, dev, tmp):
    """``ci.sh:328-338``: both codecs reveal exactly with no client
    failure, and only the binary swarm spoke binary."""
    for codec, report in legs.items():
        _check(report["ready"] and report["exact"]
               and report["client_failures"] == 0
               and report["codec"] == codec, f"codec {codec}: {report}")
    counters = {c: legs[c].get("codec_counters") or {} for c in legs}
    _check(counters["bin"].get("http.codec.bin.in", 0) > 0,
           f"codec bin: {counters['bin']}")
    _check(counters["json"].get("http.codec.bin.in", 0) == 0,
           f"codec json: {counters['json']}")
    return {c: {"sustained_rps": legs[c]["sustained_rps"],
                "codec_counters": counters[c]} for c in legs}


def _ci_poison(legs, dev, tmp):
    """``ci.sh:588-652``: every leg bit-exact; the boosted attack wrecks the
    undefended model, the norm clip recovers it, both poisoned legs chose
    the same attackers and the clerks counted every tainted upload; the
    tree leg's trimmed mean holds the target."""
    clean, undef, defend, tree = (legs[k] for k in (
        "clean", "undefended", "defended", "tree"))
    for name, leg in legs.items():
        _check(leg["exact"] is True, f"poison {name}: "
               f"{leg.get('failure_samples')}")
        _check(leg["rounds_exact"] == leg["rounds_run"]
               and leg["client_failures"] == 0, f"poison {name}: {leg}")
    curves = {name: leg["accuracy_by_round"] for name, leg in legs.items()}
    _check(clean["attack"] is None, f"poison clean: {clean['attack']}")
    _check(clean["final_accuracy"] >= 0.9, f"poison clean: {curves}")
    _check(undef["final_accuracy"] <= clean["final_accuracy"] - 0.5,
           f"poison undefended: {curves}")
    _check(defend["final_accuracy"] >= 0.9, f"poison defended: {curves}")
    for name, leg in (("undefended", undef), ("defended", defend)):
        atk = leg["attack"]
        _check(atk["attackers_total"] >= 1
               and atk["shares_tainted"] == atk["attackers_total"]
               and atk["out_of_range_detections"] >= atk["attackers_total"],
               f"poison {name}: {atk}")
    _check(undef["attack"]["attackers_by_round"]
           == defend["attack"]["attackers_by_round"],
           f"poison: attackers {undef['attack']} vs {defend['attack']}")
    _check(undef["attack"]["defended"] is False
           and defend["attack"]["defended"] is True,
           f"poison: defended flags {undef['attack']}, {defend['attack']}")
    _check(defend["quantizer"]["norm_clip"] == 0.5
           and defend["quantizer"]["headroom_margin"] > 0,
           f"poison defended: {defend['quantizer']}")
    _check(tree["reached_target"] is True, f"poison tree: {curves}")
    t = tree["attack"]
    _check(t["tree_robust"] is True and t["attackers_total"] >= 1
           and t["out_of_range_detections"] >= 1, f"poison tree: {t}")
    _check(all(r["robust_leaves"] == 3 for r in tree["per_round"]),
           f"poison tree: {tree['per_round']}")
    record = {
        "metric": ("defended final accuracy under boost:-8 poisoning "
                   "(r=0.4, L2 norm clip 0.5, secure FedAvg, 5 devices)"),
        "value": defend["final_accuracy"], "direction": "higher",
        "unit": "accuracy", "platform": defend["platform"],
        "seed": defend["seed"],
        "attack": {
            "kind": defend["attack"]["kind"],
            "rate": defend["attack"]["rate"],
            "clean_final": clean["final_accuracy"],
            "undefended_final": undef["final_accuracy"],
            "defended_final": defend["final_accuracy"],
            "recovery": round(defend["final_accuracy"]
                              - undef["final_accuracy"], 4),
            "detections": defend["attack"]["out_of_range_detections"],
            "tree_robust_final": tree["final_accuracy"]}}
    _gate("bench", record)
    return {"accuracy_by_round": curves, "attack": record["attack"]}


def _ci_trace(legs, dev, tmp):
    """``ci.sh:664-682``: bit-exact with tracing on; the Chrome trace
    parses and holds a round trace with every role that crossed the HTTP
    hop (a server span whose parent is a client attempt)."""
    report = legs["trace"]
    _check(report["ready"] and report["exact"], f"trace: {report}")
    trace = json.loads((Path(tmp) / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    by_id = {e["args"]["span_id"]: e for e in spans}
    traces = {}
    for e in spans:
        traces.setdefault(e["args"]["trace_id"], []).append(e)
    round_traces = 0
    for members in traces.values():
        roles = {e["name"].split(" ")[0].split(".")[0] for e in members}
        crossed = any(
            e["name"].startswith("http.server")
            and by_id.get(e["args"].get("parent_id", ""), {}).get("name")
            == "http.attempt" for e in members)
        if {"participant", "server", "clerk", "recipient"} <= roles \
                and crossed:
            round_traces += 1
    _check(round_traces >= 1,
           f"trace: no connected round trace among {len(traces)}")
    return {"spans": len(spans), "connected_round_traces": round_traces}


def _ci_perf(legs, dev, tmp):
    """``ci.sh:692-698``, ``:702`` and ``:709`` on each run: exact, the
    roofline block's four fields (the memory peak where the device has
    one: a card), and the pod round's registry: 2 calls of one signature,
    no retrace; then the gate over the committed records. Not
    carried over: ``ci.sh:699-701``'s ``xla.compile.*`` counters, since
    eager torch compiles nothing (ROADMAP §3's deviations)."""
    out = {}
    for name, rec in legs.items():
        _check(rec["exact"], f"perf {name}: {rec}")
        roof = rec["roofline"]
        _check(roof["flops"] > 0 and roof["bytes"] > 0
               and roof["arithmetic_intensity"] > 0
               and 0 < roof["utilization"] < 1, f"perf {name}: {roof}")
        _check(dev.type != "cuda" or roof["hbm_peak_bytes"] > 0,
               f"perf {name}: no memory peak {roof}")
        fn = rec["xla"]["functions"]["mesh.simpod.round"]
        _check(fn["calls"] == 2 and fn["compiled_shapes"] == 1
               and fn["retraces"] == 0, f"perf {name}: {fn}")
        out[name] = {"pallas": rec["pallas"], "roofline": {
            key: roof[key] for key in (
                "flops", "bytes", "arithmetic_intensity", "utilization",
                "hbm_peak_bytes", "ops_unit")}, "registry": fn}
    _gate("regress")
    return out


def _ci_recorder():
    """``ci.sh:419-420``: the recorder overhead bench as its module, within
    its 400% bar, its record gated."""
    proc = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.loadgen.recorderbench",
         *RECORDER_BENCH], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    _check(proc.returncode == 0, f"recorder bench exited "
           f"{proc.returncode}: {proc.stderr[-2000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    _gate("regress", record)
    return {key: record[key] for key in (
        "spans_per_sec_on", "spans_per_sec_off", "overhead_pct")}


CI_CHECKS = {"dead_clerk": _ci_dead_clerk, "brownout": _ci_brownout,
             "churn": _ci_churn, "storm": _ci_storm, "codec": _ci_codec,
             "poison": _ci_poison, "trace": _ci_trace, "perf": _ci_perf}


def ci_section(dev, name, smi="", connections=STORM_CONNECTIONS):
    """One section of phase 24 on ``dev``: each of its legs through the
    port's ``sda-sim`` in this process with ``ci.sh``'s arguments (the
    recorder bench as its module), then ``ci.sh``'s assertions on their
    reports and the advisory gate of its record. The perf plane's
    ``--pallas`` leg runs only on a card (K1 needs CUDA). Returns the
    section's record: its wall, what the checks keep, and each leg's K1
    and K3 launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if name == "recorder":
            rec = _ci_recorder()
            launches = {}
        else:
            legs, launches = {}, {}
            for leg, argv in CI_LEGS[name].items():
                if leg == "pallas" and dev.type != "cuda":
                    continue
                argv = [a.format(tmp=tmp, connections=connections)
                        for a in argv]
                legs[leg], n, _ = _sim(f"{name} {leg}",
                                       [*argv, "--device", str(dev)], smi)
                launches[leg] = {"k1": n["k1"], "k3": n["k3"]}
            rec = CI_CHECKS[name](legs, dev, tmp)
    return {"wall_s": time.perf_counter() - t0, **rec,
            "launches": launches}


def ci_phase(dev, smi="", connections=STORM_CONNECTIONS):
    """Phase 24: the sections of ``ci.sh`` that no other phase runs, each
    at ``ci.sh``'s sizes and with its assertions (``ci_section``): the
    dead-clerk drill's two legs, brownout, churn and the async-plane A/B,
    the connection storm, the wire codec A/B, the poisoning drill, the
    trace smoke, the device perf plane (with ``--pallas`` on a card: K1 on
    the pod's round, one launch a round, then held to plain at the round's
    shard) and the recorder bench. Every section masks with Full, so K3
    must not launch. Returns the phase's JSON record."""
    import numpy as np
    import torch

    from sda_tpu_torch.mesh import SimulatedPod, make_mesh, simpod

    sections = {}
    for name in CI_SECTIONS:
        sections[name] = ci_section(dev, name, smi, connections)
        print(f"  ci {name}: {sections[name]['wall_s']:.1f} s ({smi})")
    launches = {f"{name} {leg}": n for name, rec in sections.items()
                for leg, n in rec["launches"].items()}
    k1_err, on_card = 0, dev.type == "cuda"
    if on_card:
        _check(all(n["k3"] == 0 for n in launches.values()),
               f"ci: K3 launched in {launches}")
        _check(launches["perf pallas"]["k1"] == 2 and all(
            n["k1"] == 0 for leg, n in launches.items()
            if leg != "perf pallas"),
            f"ci: K1 launched {launches}, want 2 in the perf plane's "
            "--pallas run (a warm and a timed round) and none elsewhere")
        # the --pallas run's one shard: its inputs (default_rng(0)) and
        # the round seed 0's tile (0, 0)
        scheme, full, _ = _flagship()
        inputs = torch.from_numpy(np.random.default_rng(0).integers(
            0, 1 << 20, size=(P_PERF, D_PERF), dtype=np.int64))
        pod = SimulatedPod(scheme, full, mesh=make_mesh(1, 1, devices=[dev]))
        k1_err = _sim_shard_hold("ci perf --pallas shard", dev, pod, inputs,
                                 pod.padded_shape(P_PERF, D_PERF),
                                 simpod._tile_seed(0, 0, 0))
    return {"stage": "ci", "sections": sections,
            "storm_connections": connections,
            "k1_launches": sum(n["k1"] for n in launches.values()),
            "k3_launches": sum(n["k3"] for n in launches.values()),
            "k1_shard_max_abs_err": k1_err}


#: the repo's ``examples/`` scripts as the port's modules (phase 25), each
#: with the last line its script prints (``fedavg_lenet``'s loss is the
#: port's own: its weights are not the script's)
EXAMPLE_LAST_LINES = {
    "federated_http": r"exact vs plaintext quantized oracle: OK",
    "streamed_checkpoint": r"resumed aggregate == uninterrupted aggregate: "
                           r"OK \(bit-identical\)",
    "embedded_participant": r"C-core participation revealed exactly "
                            r"alongside the Python one: OK",
    "fedavg_lenet": r"round 3: loss \d+\.\d{4} \(secure mesh round over 4 "
                    r"encoded deltas\)",
}


def _example_checks(name, rec, k3_calls, dev):
    """Phase 25 (a)'s checks of one example's ``run`` record; returns what
    the phase keeps of it and the max |error| of its K3 holds."""
    import numpy as np
    import torch

    from sda_tpu_torch.examples import fedavg_lenet, streamed_checkpoint
    from sda_tpu_torch.models import FixedPointCodec

    ops = collections.Counter(op for op, _, _ in k3_calls.calls)
    on_card, err = dev.type == "cuda", 0
    if name != "embedded_participant":
        _check(not ops, f"{name}: K3 asked for {dict(ops)}")
    if name == "federated_http":
        _check(rec["exact"], "federated_http: mean != quantized oracle")
        return {"exact": True}, err
    if name == "streamed_checkpoint":
        sc = streamed_checkpoint
        _check(rec["calls"] == sc.DIE_AFTER + 1,
               f"streamed_checkpoint: died at call {rec['calls']}, want "
               f"{sc.DIE_AFTER + 1}")
        _check(rec["resumed"] == 20 and rec["blocks"] == 24,
               f"streamed_checkpoint: resumed {rec['resumed']} of "
               f"{rec['blocks']} blocks, want 20 of 24")
        _check(np.array_equal(rec["out"], rec["fresh"]) and np.array_equal(
            rec["out"], rec["column_sum"]),
            "streamed_checkpoint: resumed != fresh or != column sum mod 433")
        return {"exact": True, "died_at_call": rec["calls"],
                "resumed_blocks": rec["resumed"],
                "fresh_blocks": rec["blocks"]}, err
    if name == "embedded_participant":
        _check(rec["exact"], f"embedded_participant: {rec['out']} != "
               f"{rec['expected']}")
        if on_card:
            _check(ops == {"expand": 1, "combine": 1},
                   f"embedded_participant: K3 calls {dict(ops)}, want one "
                   "expand and one combine")
            err = max(_k3_call_hold(f"examples {name}", *c)
                      for c in k3_calls.calls)
        return {"exact": True, "out": [int(v) for v in rec["out"]]}, err
    fl = fedavg_lenet
    codec = FixedPointCodec(fl.M31, fl.FRACTIONAL_BITS, fl.N_CLIENTS,
                            clip=fl.CLIP)
    for r, cohort in enumerate(rec["cohorts"]):
        gvec = rec["globals"][r]
        want = gvec + codec.decode_mean(_fedavg_oracle(
            codec, torch.from_numpy(cohort), torch.from_numpy(gvec),
            fl.M31), fl.N_CLIENTS)
        _check(np.array_equal(rec["globals"][r + 1], want),
               f"fedavg_lenet: round {r + 1}'s global != the oracle's")
    _check(all(np.isfinite(rec["losses"])),
           f"fedavg_lenet: losses {rec['losses']}")
    _check(rec["params_device"].split(":")[0] == dev.type,
           f"fedavg_lenet: params on {rec['params_device']}, not {dev}")
    return {"exact": True, "param_count": rec["param_count"],
            "losses": rec["losses"],
            "params_device": rec["params_device"]}, err


def examples_phase(dev, smi=""):
    """Phase 25: the repo's four ``examples/`` as the port runs them
    (``sda_tpu_torch/examples/``), at their own sizes. (b) starts
    ``python -m sda_tpu_torch.examples.<name> --device <dev>`` for all
    four at once, as processes that share a bytecode cache; each must exit
    0 with its script's last line. (a) calls each ``run(dev)`` in this
    process meanwhile, under ``DeviceCounts`` and ``K3Calls``:
    ``federated_http``'s mean equals its quantized oracle bit for bit (its
    d=32 keeps every field op on the host); ``streamed_checkpoint`` dies
    at the 6th provider call, resumes in 20 blocks, and equals a fresh run
    and the column sum mod 433; ``embedded_participant`` reveals exactly,
    and on a card K3 launches once for the Python participant's expand and
    once for the recipient's combine, each held to plain on its seeds;
    ``fedavg_lenet``'s every new global equals the host encode's oracle
    bit for bit, its losses are finite and its weights on ``dev``. K1
    never launches. Returns the phase's JSON record."""
    from sda_tpu_torch import examples

    on_card = dev.type == "cuda"
    records, k3_err, k3_total = {}, 0, 0
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(examples.EXAMPLES)) as pool:
        env = Processes(tmp, None)
        t_b = time.perf_counter()

        def example_process(name):
            proc = subprocess.Popen(
                [sys.executable, "-m", f"sda_tpu_torch.examples.{name}",
                 "--device", str(dev)], cwd=env.cwd, env=env.env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                out, err_text = proc.communicate(timeout=ROLE_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
            return proc.returncode, out, err_text, time.perf_counter() - t_b

        procs = {name: pool.submit(example_process, name)
                 for name in examples.EXAMPLES}
        t_a = time.perf_counter()
        for name in examples.EXAMPLES:
            module = importlib.import_module(f"sda_tpu_torch.examples.{name}")
            k3, k1 = _k3_reset(), _k1_reset()
            with DeviceCounts() as counts, K3Calls() as k3_calls:
                t0 = time.perf_counter()
                rec = module.run(dev)
                _sync(dev)
                wall = time.perf_counter() - t0
            launches = dict(k3.op_launches)
            _check(k1.launches == 0, f"{name}: K1 launched {k1.launches}")
            one = int(name == "embedded_participant")
            _check(not on_card or launches == {
                "blocks": 0, "expand": one, "combine": one, "mask": 0},
                f"{name}: K3 launches {launches}")
            kept, err = _example_checks(name, rec, k3_calls, dev)
            calls = {op: dict(c) for op, c in counts.calls.items() if c}
            if name == "federated_http":
                _check(not calls, f"federated_http: device calls {calls}, "
                       "want none under HOST_PATH_MAX")
            k3_err = max(k3_err, err)
            k3_total += sum(launches.values())
            records[name] = {"wall_s": wall, "device_calls": calls,
                             "k3_launches": launches, **kept}
            print(f"  examples {name} in process: {wall:.2f} s ({smi})")
        records["fedavg_lenet"]["precision"] = _lenet_precision(
            dev, records["fedavg_lenet"]["losses"])
        wall_a = time.perf_counter() - t_a
        outs = {name: fut.result() for name, fut in procs.items()}
    wall_b = max(o[3] for o in outs.values())
    for name, (rc, out, err_text, wall) in outs.items():
        lines = out.strip().splitlines()
        if rc != 0:
            print(err_text[-4000:], file=sys.stderr)
        _check(rc == 0, f"python -m sda_tpu_torch.examples.{name}: exit {rc}")
        want = EXAMPLE_LAST_LINES[name]
        _check(bool(lines) and re.fullmatch(want, lines[-1]),
               f"{name}: last line {lines[-1:]}, want /{want}/")
        records[name]["process"] = {"rc": rc, "wall_s": wall,
                                    "last_line": lines[-1]}
    print(f"  examples as processes: {wall_b:.1f} s for the four at once "
          f"({smi})")
    return {"stage": "examples", "examples": records,
            "in_process_s": wall_a, "processes_s": wall_b,
            "k3_launches": k3_total, "k3_max_abs_err": k3_err,
            "device": str(dev)}


def _k3_record(k3_rec, rec13, rec15, k3_launches, k3_err, seed_calls):
    """K3's entries of the script's kernel line, one an operation: its
    phase 12 times and bound (``k3_rec``, from ``chacha_kernels``), its
    launches on the path that runs it (the streamed round's mask ops in
    ``rec15``, the ChaCha role crypto's expands and combine in ``rec13``),
    K3's launches by phase and max |error| over every hold."""
    ops = k3_rec["ops"]
    rows = (
        ("chacha_mask", "mask_derived",
         "sda_tpu/mesh/simpod.py:214 with :192 _chacha_seed_words and the "
         "accumulate of sda_tpu/mesh/streaming.py:503-505",
         rec15["k3_launches"]["mask"],
         {"launches_of": "the streamed round (phase 15)",
          "launches_derived": rec15["k3_derived_launches"],
          "ms_of": "derived keys, into an accumulator, int32 out",
          "given_seeds": ops["mask"], "int64_out": ops["mask_int64"],
          "seed_word_calls_by_phase": seed_calls}),
        ("chacha_expand", "expand", "sda_tpu/fields/chacha_jax.py:78",
         rec13["k3_launches"]["expand"],
         {"launches_of": "the ChaCha role crypto (phase 13)"}),
        ("combine_masks", "combine", "sda_tpu/fields/chacha_jax.py:170",
         rec13["k3_launches"]["combine"],
         {"launches_of": "the ChaCha role crypto (phase 13)",
          "launches_by_phase": k3_launches,
          **{key: ops["combine"][key] for key in (
              f"ms_s{S_BIG}", f"bound_ms_s{S_BIG}", "host_ms")}}),
        ("chacha_blocks", "blocks", "sda_tpu/fields/chacha_jax.py:51", 0,
         {"launches_of": "no path"}))
    return [{"name": name, "route": "cuda",
             "source": "sda_tpu_torch/fields/csrc/chacha.cu",
             "replaces": replaces, "launches": launches,
             "max_abs_err": k3_err,
             **{key: ops[op][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "share", "shape",
                 "ptxas", "seed_loop")},
             "library_ms": None, **extra}
            for name, op, replaces, launches, extra in rows]


def main() -> int:
    t_script = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "sda_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: sda_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    import numpy as np

    from sda_tpu_torch.benchmarks import kernel_probe
    from sda_tpu_torch.benchmarks.bounds import (INSTR_PER_S,
                                                 WHOLE_ROUND_MULS,
                                                 WHOLE_ROUND_XORS)
    from sda_tpu_torch.benchmarks.bounds import k1_bound as _bound
    from sda_tpu_torch.benchmarks.bounds import philox_ops
    from sda_tpu_torch.fields import _build, fused_round, numtheory
    from sda_tpu_torch.fields.dimtile import tile_plan
    from sda_tpu_torch.fields.sharing import batch_columns, unbatch_columns
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import (BasicShamirSharing, FullMasking,
                                        PackedShamirSharing)
    from sda_tpu_torch.utils import sass
    from sda_tpu_torch.utils.benchtime import median_ms

    K1 = fused_round.fused_mask_share_combine
    K5 = kernel_probe.probe_call
    dev = torch.device(DEVICE)

    # -- 1. the card -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, Python {sys.version.split()[0]}")

    # -- 2. build K1, K5, K3, K4, K6, K7 and K8, one nvcc each, side by side
    t0 = time.perf_counter()
    names = ("fused_round", "kernel_probe", "chacha", "montgomery",
             "blockgen", "reveal", "residues")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {', '.join(built[n][0].name for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def report(label, lib, info, kernel):
        """Print a kernel's ptxas line and the SASS opcode mix of its
        participant loop; fail on a spill. Returns the loop's opcode mix
        and its count of Philox multiplies."""
        ptx = next((v for key, v in info.items() if kernel in key), None)
        _check(ptx is not None, f"{kernel}: no ptxas line")
        _check(not sass.spills(ptx), f"{kernel} spills: {'; '.join(ptx)}")
        lines = sass.loop_instructions(lib, cuobjdump, kernel)
        mix = collections.Counter(op for op, _ in lines)
        muls = sass.philox_muls(lines)
        print(f"  {label} ({kernel}): {'; '.join(ptx)}; participant loop "
              f"{sum(mix.values())} instructions, {muls} Philox multiplies: "
              + ", ".join(f"{op} {c}" for op, c in mix.most_common()))
        return mix, muls

    lib_path, log = built["fused_round"]
    k1_ptxas = sass.ptxas_info(log)
    for kernel, ptx in k1_ptxas.items():  # the R = 16 variants too
        _check(not sass.spills(ptx), f"{kernel} spills: {'; '.join(ptx)}")
    k1_mix, k1_warps = {}, {}
    for instance, kernel in K1_KERNELS.items():
        k1_mix[instance], muls = report(f"K1 {instance}", lib_path,
                                        k1_ptxas, kernel)
        warps = k1_warps[instance] = (
            fused_round.resident_blocks(instance) * 256 // 32)
        print(f"    resident warps an SM: {warps} (256-thread blocks, "
              "cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        if instance == "columns":
            k1_mul = muls
    loop_mix = k1_mix["columns"]
    probe_lib, probe_log = built["kernel_probe"]
    probe_ptxas = sass.ptxas_info(probe_log)
    probe_mix, probe_muls = {}, {}
    for name, flags in kernel_probe.VARIANTS.items():
        inst = "probe_kernelI" + "".join(
            f"Lb{int(bool(flags.get(f)))}E"
            for f in ("do_x", "do_prng", "do_matmul", "tree")) + "E"
        probe_mix[name], probe_muls[name] = report(
            f"K5 {name}", probe_lib, probe_ptxas, inst)
    prng_mul = probe_muls["prng_only"]
    print(f"  Philox multiplies a compiled participant: prng_only "
          f"{prng_mul / UNROLL}, K1 {k1_mul / UNROLL}")
    _check(prng_mul == k1_mul and k1_mul > 0,
           f"prng_only's loop holds {prng_mul} Philox multiplies, K1's "
           f"{k1_mul}: draws were compiled away")
    loops = {name: sum(probe_mix[name].values())
             for name in ("no_matmul", "full")}
    _check(loops["no_matmul"] == loops["full"],
           f"the loops of no_matmul and full differ: {loops}")

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    flagship = PackedShamirSharing(3, 8, t, p, w2, w3)
    basic = BasicShamirSharing(share_count=8, privacy_threshold=3,
                               prime_modulus=p)
    sp = SolinasPrime.try_from(p)
    _check(sp is not None and p == (1 << 29) - 679,
           f"flagship prime {p} is not 2^29 - 679")
    rng = np.random.default_rng(0)
    max_err = {"K1": 0, "K5": 0}

    def hold(case, got, want, kernel="K1"):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _check(g.dtype == w.dtype and g.shape == w.shape,
                   f"{case}: {g.dtype}{tuple(g.shape)} vs "
                   f"{w.dtype}{tuple(w.shape)}")
            err = int((g - w).abs().max()) if g.numel() else 0
            max_err[kernel] = max(max_err[kernel], err)
            _check(torch.equal(g, w), f"{case}: kernel != plain version")
        print(f"  {case}: equal")

    def words(shape):
        return torch.from_numpy(
            rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)).to(dev)

    def k1_hold(case, instance, args, **kw):
        """K1 against its plain version on the same arguments; the call
        must run the given instance."""
        before = dict(K1.instance_launches)
        got = K1(*args, **kw)
        ran = [i for i in fused_round.INSTANCES
               if K1.instance_launches[i] != before[i]]
        _check(ran == [instance], f"{case}: ran {ran}, want {instance}")
        hold(f"{case} [{instance}]", got,
             fused_round.fused_mask_share_combine_plain(*args, **kw))

    def batch_view(P, d):
        """The main path's layout: the batch_columns view of [P, d] words."""
        return batch_columns(words((P, d)).view(torch.int32), 3)

    # -- 3. K1 vs its plain version, external bits --------------------------
    # the external instance at k + t <= 8 and, with the 26-clerk committee's
    # k=7, t=8, at 16; a ragged B that is not a multiple of 4
    print("K1 vs plain, external bits (tolerance: exact, torch.equal):")
    packed26 = _sim_scheme(7, 26, "packed")
    for scheme, sizes in (
            (flagship, ((7, 1000, False), (P_MAIN, D_MAIN // 3, True))),
            (basic, ((7, 1000, False), (P_MAIN, D_MAIN // 3, True))),
            (packed26, ((7, 1000, False), (33, 3003 // 7, True)))):
        k, ts = scheme.secret_count, scheme.privacy_threshold
        m_host = numtheory.share_matrix_for(scheme)
        s_sp = SolinasPrime.try_from(scheme.prime_modulus)
        for P, B, strided in sizes:
            for masked in (True, False):
                draws = (k + ts) if masked else ts
                if strided:  # the main path's layout: a view of [P, d]
                    x_cols = batch_columns(words((P, k * B)).view(torch.int32), k)
                else:
                    x_cols = words((P, k, B))
                bits = words((P, 2 * draws, B))
                k1_hold(f"{type(scheme).__name__}(k={k}, t={ts}) P={P} B={B} "
                        f"masked={masked}", "external",
                        (x_cols, 0, s_sp, m_host, ts, masked),
                        external_bits=bits)
                del x_cols, bits
                torch.cuda.synchronize()

    # -- 4. K1 internal Philox draws ---------------------------------------
    # every instance: the main path's take the strided view, masked or
    # not; P=33 x d=3003 makes every participant's run start at another
    # word offset mod 4 and leaves a ragged last block
    print("K1 vs plain, internal Philox draws (tolerance: exact):")
    m_flag = numtheory.share_matrix_for(flagship)
    for P, d, strided, masked in (
            (7, 3000, False, True), (7, 3000, False, False),
            (7, 3000, True, True), (7, 3000, True, False),
            (33, 3003, True, True), (33, 3003, True, False),
            (P_MAIN, D_MAIN, False, True), (P_MAIN, D_MAIN, True, True),
            (P_MAIN, D_MAIN, True, False)):
        x_cols = batch_view(P, d) if strided else words((P, 3, d // 3))
        instance = ("generic" if not strided else
                    "columns" if masked else "columns_unmasked")
        k1_hold(f"PackedShamir P={P} d={d} "
                f"{'strided' if strided else 'contiguous'} masked={masked}",
                instance,
                (x_cols, 12345 + P, sp, m_flag, t, masked))
        del x_cols
        torch.cuda.synchronize()
    # the column instances of the other schemes, at the main path's sizes
    # (P=33 x d=3003 ragged), each on the batch_columns view, masked and
    # not, held to plain; at P_MAIN x D_MAIN each is timed beside its bound
    # (the Philox blocks its loop draws, bounds.philox_ops)
    k1_instances = {}
    t_others = time.perf_counter()
    big = words((P_MAIN, D_MAIN)).view(torch.int32)
    for name, (k, ts, n_clerks, sharing) in K1_SCHEMES.items():
        scheme = _sim_scheme(k, n_clerks, sharing)
        _check((scheme.secret_count, scheme.privacy_threshold) == (k, ts),
               f"{name}: sda-sim's scheme is {scheme}")
        s_sp = SolinasPrime.try_from(scheme.prime_modulus)
        m_host = numtheory.share_matrix_for(scheme)
        for P, d in ((7, 3000), (33, 3003), (P_MAIN, D_MAIN)):
            x_cols = batch_columns(
                big if P == P_MAIN else words((P, d)).view(torch.int32), k)
            for masked in (True, False):
                instance = name if masked else f"{name}_unmasked"
                args = (x_cols, 4242 + P, s_sp, m_host, ts, masked)
                k1_hold(f"{type(scheme).__name__}(k={k}, t={ts}, "
                        f"n={n_clerks}) P={P} d={d} masked={masked}",
                        instance, args)
                if P == P_MAIN:
                    B = x_cols.shape[-1]
                    inst_ms = median_ms(lambda: K1(*args), dev, reps=20)
                    inst_bound = _bound(P, B, k, (k if masked else 0) + ts,
                                        True, n_clerks + (k if masked else 0),
                                        *philox_ops(k, ts, masked))
                    k1_instances[instance] = {
                        "k": k, "t": ts, "n": n_clerks, "P": P, "B": B,
                        "ms": inst_ms, "bound_ms": inst_bound[0],
                        "bound_by": inst_bound[1],
                        "resident_warps": k1_warps[instance]}
                    print(f"  {instance} at P={P} B={B}: {inst_ms:.4f} ms "
                          f"median of 20; bound {inst_bound[0]:.4f} ms "
                          f"({inst_bound[2]})")
            del x_cols
            torch.cuda.synchronize()
    del big
    # the run-time shapes beyond one scheme each: k=1, t=2 and k=2, t=1 at
    # 8 clerks (sda-sim --secrets-per-batch 1 or 2), BasicShamir at 26
    # clerks (k=1, t=12), and k=10, t=6 (k + t = 16) on a random 32 x 17
    # matrix
    wide_m = rng.integers(0, p, size=(32, 17))
    for case, k, ts, n_clerks, sharing in (
            ("--secrets-per-batch 1", 1, 2, 8, "packed"),
            ("--secrets-per-batch 2", 2, 1, 8, "packed"),
            ("--sharing basic --clerks 26", 1, 12, 26, "basic"),
            ("k=10, t=6, random matrix", 10, 6, 32, None)):
        if sharing is None:
            m_host, s_sp = wide_m, sp
        else:
            scheme = _sim_scheme(k, n_clerks, sharing)
            _check(scheme.privacy_threshold == ts, f"{case}: {scheme}")
            m_host = numtheory.share_matrix_for(scheme)
            s_sp = SolinasPrime.try_from(scheme.prime_modulus)
        x_cols = batch_columns(words((33, 3003)).view(torch.int32), k)
        for masked in (True, False):
            instance = ("columns_r8" if k + ts <= 8 else "columns_r16") + (
                "" if masked else "_unmasked")
            k1_hold(f"{case} P=33 d=3003 masked={masked}", instance,
                    (x_cols, 99, s_sp, m_host, ts, masked))
    print(f"  the other schemes' instances: 32 holds and 8 timings in "
          f"{time.perf_counter() - t_others:.1f} s")

    # K1's accumulate options (the streamed step's donated accumulators)
    k1_tile, k1_acc_err = k1_accumulate(dev, rng)
    max_err["K1"] = max(max_err["K1"], k1_acc_err)
    small = torch.from_numpy(
        rng.integers(0, 1 << 20, size=(7, 3001), dtype=np.uint32)).to(dev)
    small_fn = fused_round.single_chip_round_pallas(flagship, FullMasking(p),
                                                        device=dev)
    out = small_fn(small, torch.Generator().manual_seed(4))
    _check(torch.equal(out, small.to(torch.int64).sum(0) % p),
           "internal-mode round (P=7, d=3001) != plain sum")
    print("  round on internal draws (P=7, d=3001) == plain sum")

    # -- 5. the main path at full width -------------------------------------
    inputs = torch.from_numpy(rng.integers(
        0, 1 << 20, size=(P_MAIN, D_MAIN), dtype=np.uint32)).to(dev)
    expect = inputs.to(torch.int64).sum(0) % p
    gen = torch.Generator()     # seeds K1 on the host: no wait on the card
    for label, dim_tile, want_launches in (
            ("fused round", None, 1),
            (f"fused round, dim_tile={DIM_TILE}", DIM_TILE,
             tile_plan(D_MAIN, 24, DIM_TILE).n_tiles)):   # grain lcm(3, 8)
        fn = fused_round.single_chip_round_pallas(
            flagship, FullMasking(p), dim_tile=dim_tile, device=dev)
        gen.manual_seed(0)
        K1.launches = K5.launches = 0
        K1.instance_launches.update(dict.fromkeys(fused_round.INSTANCES, 0))
        K7, K8 = _k7_k8_reset()
        out = fn(inputs, gen)
        torch.cuda.synchronize()
        launches, round_k5_launches = K1.launches, K5.launches
        k7_launches, k8_launches = K7.launches, K8.launches
        # one reveal a tile on K7, no modmatmul32 chain; uint32 inputs are
        # read in place by K1, so no K8 pass
        _check(k7_launches == want_launches and K8.launches == 0,
               f"{label}: K7 launched {k7_launches} times, K8 "
               f"{K8.launches}; want {want_launches} and 0")
        _check(K1.instance_launches["columns"] == launches,
               f"{label}: K1 instances {K1.instance_launches}, want every "
               "launch on the main path's")
        _check(out.dtype == torch.int64 and out.shape == (D_MAIN,),
               f"{label}: output {out.dtype}{tuple(out.shape)}")
        _check(torch.equal(out, expect), f"{label}: != plain sum mod p")
        _check(launches == want_launches,
               f"{label}: K1 launched {launches} times, want {want_launches}")
        ms = _median_ms(lambda: fn(inputs, gen), reps=10)
        _check(round_k5_launches == 0, f"{label}: K5 launched on the round")
        if dim_tile is None:
            main_launches, main_k7_launches = launches, k7_launches
        print(f"{label}: exact, K1 launches {launches}, K7 {k7_launches}, "
              f"K8 {k8_launches}, round {ms:.3f} ms "
              f"median of 10, {P_MAIN * D_MAIN / (ms / 1e3):.4e} "
              f"shared-elements/s")
        _profile(label, lambda: fn(inputs, gen))

    # K1 alone at the main path's shapes and mode (internal draws)
    x_main = batch_columns(inputs.view(torch.int32), 3)
    B_main = x_main.shape[-1]
    k1_args = (x_main, 7, sp, m_flag, t, True)
    k1_ms = median_ms(lambda: K1(*k1_args), dev, reps=20)
    plain_ms = median_ms(
        lambda: fused_round.fused_mask_share_combine_plain(*k1_args),
        dev, reps=3, warmup=1)
    # the work these inputs need (3 input rows, 3 + t drawn rows, shares
    # and mask totals out), counted from the algorithm
    n = flagship.share_count
    bound_ms, bound_by, detail = _bound(P_MAIN, B_main, 3, 3 + t, True,
                                        n + 3)
    whole_ms, _, whole_detail = _bound(P_MAIN, B_main, 3, 3 + t, True,
                                       n + 3, WHOLE_ROUND_MULS,
                                       WHOLE_ROUND_XORS)
    loop_ms = (sum(loop_mix.values()) / UNROLL * P_MAIN * B_main
               / INSTR_PER_S * 1e3)
    print(f"K1 at P={P_MAIN} B={B_main} (internal draws, main path's "
          f"instance): {k1_ms:.4f} ms median of 20 (CUDA events); plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({detail}); with the "
          f"whole-round count {whole_ms:.4f} ms ({whole_detail}); its "
          f"compiled loop of {sum(loop_mix.values())} instructions ({UNROLL} "
          f"participants) needs {loop_ms:.4f} ms to issue")

    # -- 6. the plain-torch round on the card -------------------------------
    plain_fn = single_chip_round(flagship, FullMasking(p), device=dev)
    dev_gen = torch.Generator(device=dev).manual_seed(0)
    out = plain_fn(inputs, dev_gen)
    _check(torch.equal(out, expect), "plain single_chip_round != plain sum")
    plain_round_ms = _median_ms(lambda: plain_fn(inputs, dev_gen), reps=5,
                                warmup=1)
    print(f"plain single_chip_round: exact, {plain_round_ms:.3f} ms median "
          f"of 5, {P_MAIN * D_MAIN / (plain_round_ms / 1e3):.4e} "
          f"shared-elements/s")
    _profile("plain single_chip_round", lambda: plain_fn(inputs, dev_gen))

    # -- 7. K5, the kernel probe, at the main path's width -----------------
    print("K5 vs plain (tolerance: exact, torch.equal):")
    checked = dict(kernel_probe.VARIANTS, x_matmul=kernel_probe.X_MATMUL)
    for P, B, x_cols in ((7, 1000, batch_view(7, 3000)),
                         (33, 1001, batch_view(33, 3003)),
                         (P_MAIN, B_main, x_main)):
        args = (x_cols, 4321 + P, sp, m_flag, t)
        got = {}
        for name, flags in checked.items():
            got[name] = K5(*args, **flags)
            hold(f"{name} P={P} B={B}", [got[name]],
                 [kernel_probe.probe_call_plain(*args, **flags)], "K5")
        hold(f"full == K1 shares, same seed, P={P} B={B}", [got["full"]],
             [K1(*args, True)[0]], "K5")
        for tree, twin in (("fold_tree", "fold_only"), ("full_tree", "full")):
            hold(f"{tree} == {twin} P={P} B={B}", [got[tree]], [got[twin]],
                 "K5")
        del got
    hold(f"mxu_fold == xla_fold P={P_MAIN} d={D_MAIN}",
         [kernel_probe.mxu_fold(inputs, sp)],
         [kernel_probe.xla_fold(inputs, sp)], "K5")

    # the probe's entry point, as a user runs it, at the flagship width
    records = []

    def emit(stage, **kw):
        records.append({"stage": stage, **kw})
        print(json.dumps(records[-1]), flush=True)

    K1.launches = K5.launches = 0
    rc = kernel_probe.main(["--participants", str(P_MAIN),
                            "--dim", str(D_MAIN)], emit=emit)
    torch.cuda.synchronize()
    probe_launches = K5.launches
    _check(rc == 0, f"kernel probe exited {rc}")
    _check(probe_launches > 0, "the kernel probe never launched K5")
    print(f"kernel probe: exit 0, K5 launches {probe_launches}, K1 "
          f"launches {K1.launches}")
    comp = {r["name"]: r for r in records if r["stage"] == "component"}
    _check(set(comp) == set(kernel_probe.VARIANTS),
           f"component lines for {sorted(comp)}")

    # plain versions, bounds and the library fold on the probe's inputs
    x_probe = batch_columns(kernel_probe.probe_inputs(
        P_MAIN, D_MAIN, sp, dev).view(torch.int32), 3)
    lib_ms = median_ms(
        lambda: torch.remainder(x_probe.to(torch.int64).sum(0), p), dev)
    k5 = {}
    for name, flags in kernel_probe.VARIANTS.items():
        args = (x_probe, 100, sp, m_flag, t)
        v_plain_ms = median_ms(
            lambda: kernel_probe.probe_call_plain(*args, **flags), dev,
            reps=3, warmup=1)
        v_bound, v_by, v_detail = _bound(
            P_MAIN, B_main, 3, 3 + t if flags["do_prng"] else 0,
            flags["do_x"], n)
        k5[name] = {"ms": comp[name]["ms"], "plain_ms": v_plain_ms,
                    "bound_ms": v_bound, "bound_by": v_by,
                    "library_ms": lib_ms if name == "fold_only" else None}
        loop = sum(probe_mix[name].values())
        print(json.dumps({"stage": "component_bound", "name": name,
                          **k5[name], "loop_instructions": loop,
                          "issue_ms": loop / UNROLL
                          * (kernel_probe.TREE_GROUP if flags.get("tree")
                             else 1)
                          * P_MAIN * B_main / INSTR_PER_S * 1e3,
                          "detail": v_detail}))
    del x_probe
    print(f"library fold (torch.remainder(x.to(int64).sum(0), p)) at "
          f"P={P_MAIN} B={B_main}: {lib_ms:.4f} ms median of 20 "
          f"(CUDA events); fold_only kernel {k5['fold_only']['ms']:.4f} ms")

    # -- 9. the role crypto at the flagship width, no transport -----------
    print(f"role crypto: flagship scheme, Full masking, P={P_ROLE} x "
          f"d={D_MAIN} ({smi}):")
    print(json.dumps(role_crypto(dev, P_ROLE, D_MAIN)), flush=True)

    # -- 9b. the port's host crypto, built from the checkout --------------
    from sda_tpu_torch.crypto import sharing
    from sda_tpu_torch.protocol import ChaChaMasking

    print(f"host crypto: sealed boxes and Ed25519 from crypto/csrc/sodium.c, "
          f"known answers from libsodium 1.0.18 (host of {smi}):")
    print(json.dumps(host_crypto()), flush=True)

    # -- 10-11. protocol rounds through SdaClient ---------------------------
    t10 = time.perf_counter()
    print(f"protocol round: memory server, P={P_PROTOCOL} x d={D_MAIN} "
          f"({smi}):")
    print(json.dumps(protocol_round(dev, P_PROTOCOL, D_MAIN)), flush=True)
    print(f"protocol round, ChaCha masks on K3: memory server, "
          f"P={P_PROTOCOL} x d={D_CHACHA} ({smi}):")
    rec10b = protocol_round(dev, P_PROTOCOL, D_CHACHA,
                            masking=ChaChaMasking(p, D_CHACHA, 128))
    print(json.dumps(rec10b), flush=True)
    for host_path_max in (sharing.HOST_PATH_MAX, 0):
        print(json.dumps(http_round(dev, host_path_max)), flush=True)
    print(f"phases 10-11: {time.perf_counter() - t10:.1f} s")

    # -- 12. K3 vs its plain version and the host spec, timed --------------
    # from here on the paths' host derivations of ChaCha seed words are
    # counted (phases 14, 15, 17, 18 and 22 must make none)
    _count_seed_words()
    print(f"K3 vs plain and host spec (tolerance: exact, torch.equal; {smi}):")
    k3_rec = chacha_kernels(dev, p, *built["chacha"], cuobjdump)

    # -- 13. the role crypto with ChaCha masks through K3 ------------------
    print(f"role crypto: flagship scheme, ChaCha masking, P={P_ROLE} x "
          f"d={D_CHACHA} ({smi}):")
    rec13 = role_crypto(dev, P_ROLE, D_CHACHA,
                        masking=ChaChaMasking(p, D_CHACHA, 128))
    print(json.dumps(rec13), flush=True)

    # -- 14. single_chip_round with ChaCha masks ---------------------------
    print(f"ChaCha single_chip_round: P={P_MAIN} x d={D_CHACHA} ({smi}):")
    rec14 = chacha_round(dev, P_MAIN, D_CHACHA)
    print(json.dumps(rec14), flush=True)

    # -- 14b. K6, the device block provider's kernel ------------------------
    print(f"K6 vs plain and the host provider (tolerance: exact, "
          f"torch.equal; {smi}):")
    t14b = time.perf_counter()
    k6_rec = blockgen_kernels(dev, p, *built["blockgen"], cuobjdump)
    k6_rec["phase_s"] = time.perf_counter() - t14b
    print(json.dumps(k6_rec), flush=True)

    # -- 14c. K7, the reveal, and K8, the residue pass ---------------------
    print(f"K7 and K8 vs plain, K3's mask op on raw blocks (tolerance: exact, "
          f"torch.equal; {smi}):")
    t14c = time.perf_counter()
    k78_rec = reveal_kernels(dev, p, built["reveal"][1],
                             built["residues"][1])
    k78_rec["phase_s"] = time.perf_counter() - t14c
    print(json.dumps(k78_rec), flush=True)
    print(f"phase 14c: {k78_rec['phase_s']:.1f} s")

    # -- 15. the streamed round on K1 and K3, and the device-tile fold -----
    print(f"streamed round: ChaCha masking, use_pallas=True ({smi}):")
    t15 = time.perf_counter()
    rec15 = streamed_round(dev, P_STREAM, D_STREAM, STREAM_CHUNK)
    rec15["phase_s"] = time.perf_counter() - t15
    print(json.dumps(rec15), flush=True)
    k3_launches = {"protocol_round_chacha":
                   sum(rec10b["k3_launches"].values()),
                   "role_crypto": sum(rec13["k3_launches"].values()),
                   "chacha_round": sum(rec14["k3_launches"].values()),
                   "streamed_round": sum(rec15["k3_launches"].values())}

    # -- 16. K4: the Paillier premix, against plain, Python ints, host -----
    print(f"K4 vs plain, Python ints and the host fold (tolerance: exact, "
          f"torch.equal and byte-identical frames; {smi}):")
    t16 = time.perf_counter()
    k4_rec = premix_phase(dev, built["montgomery"][1])
    k4_rec["phase_s"] = time.perf_counter() - t16
    print(json.dumps(k4_rec), flush=True)
    print(f"premix server: SdaHttpServer over the memory server, "
          f"premix_paillier, SDA_PREMIX_DEVICE=1, P={P_PREMIX_SERVER} x "
          f"d={D_PREMIX_SERVER}, {PREMIX_SERVER_SCHEME[3]}-bit PackedPaillier "
          f"clerks ({smi}):")
    t16b = time.perf_counter()
    rec16b = premix_server_phase(dev)
    rec16b["phase_s"] = time.perf_counter() - t16b
    print(json.dumps(rec16b), flush=True)
    k4_launches = {"premix": k4_rec["launches"],
                   "premix_server": rec16b["k4_launches"]}

    # -- 17. the bench plane ------------------------------------------------
    print(f"bench: the port's bench at P={P_MAIN} x d={D_MAIN} ({smi}):")
    t17 = time.perf_counter()
    rec17 = bench_phase(dev, k1_ms)
    print(json.dumps(rec17), flush=True)
    print(f"streamed round once more, cost capture and profiler on ({smi}):")
    rec17s = streamed_profile(dev, P_STREAM, D_STREAM, STREAM_CHUNK,
                              rec15["out_sha256"])
    print(json.dumps(rec17s), flush=True)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # -- 18. the pod round at the flagship width ---------------------------
    print(f"pod round: SimulatedPod, P={P_MAIN} x d={D_MAIN}, 1x1 and "
          f"virtual 4x2 meshes ({smi}):")
    t18 = time.perf_counter()
    rec18 = pod_phase(dev)
    rec18["phase_s"] = time.perf_counter() - t18
    print(json.dumps(rec18), flush=True)

    # -- 19. run_devscale at the model-scale rung --------------------------
    print(f"devscale: dim={DEVSCALE_DIM}, P=8, virtual 4x2 mesh, full "
          f"masks, K1 ({smi}):")
    t19 = time.perf_counter()
    rec19 = devscale_phase(dev)
    rec19["phase_s"] = time.perf_counter() - t19
    print(json.dumps(rec19), flush=True)

    # -- 20. multihost at world size 1 over NCCL ---------------------------
    print(f"multihost: world size 1, P={P_MAIN} x d={D_MAIN} ({smi}):")
    t20 = time.perf_counter()
    rec20 = multihost_phase(dev)
    rec20["phase_s"] = time.perf_counter() - t20
    print(json.dumps(rec20), flush=True)
    print(f"phases 18-20: {time.perf_counter() - t18:.1f} s")
    k3_launches["pod_round"] = sum(rec18["k3_launches"].values())

    # -- 21. FedAvg on the card --------------------------------------------
    print(f"fedavg: P={P_FEDAVG} MobileLite (SimulatedPod 1x1, 4x2) and "
          f"LoRAMLP adapters (StreamedPod 4x2), K1; run_devscale by family "
          f"({smi}):")
    t21 = time.perf_counter()
    K7, K8 = _k7_k8_reset()
    rec21 = fedavg_phase(dev)
    rec21["phase_s"] = time.perf_counter() - t21
    rec21["k7_launches"], rec21["k8_launches"] = K7.launches, K8.launches
    _check(K7.launches > 0, "fedavg: K7 never launched")
    print(json.dumps(rec21), flush=True)
    print(f"phase 21: {rec21['phase_s']:.1f} s; K7 {K7.launches}, K8 "
          f"{K8.launches} launches")

    # -- 22. the port's sda-sim ---------------------------------------------
    print(f"sim: the port's sda-sim at P={P_MAIN} x d={D_MAIN}: pod, "
          f"streamed, quorum, one multihost worker, devscale ({smi}):")
    t22 = time.perf_counter()
    K7, K8 = _k7_k8_reset()
    rec22 = sim_phase(dev, smi)
    rec22["phase_s"] = time.perf_counter() - t22
    rec22["k7_launches"], rec22["k8_launches"] = K7.launches, K8.launches
    _check(K7.launches > 0, "sim: K7 never launched")
    print(json.dumps(rec22), flush=True)
    print(f"phase 22: {rec22['phase_s']:.1f} s; K7 {K7.launches}, K8 "
          f"{K8.launches} launches in this process")
    k3_launches["sim"] = rec22["k3_launches"]
    k3_launches["sim_drills"] = rec22["k3_launches_drills"]

    # -- 23. the deployment as processes ------------------------------------
    # K3 and K4 launch in the role processes and in sdad there, where this
    # script cannot count them; an exact reveal holds K4, and K3 is held
    # to plain on the round's own seeds
    print(f"deployment: sdad and sda processes on {DEVICE}, P={P_DEPLOY} x "
          f"d={D_DEPLOY} (MobileLite's width), ChaCha masks, packed Shamir "
          f"over 8 clerks with clerk {DEPLOY_ABSENT} absent, participant 0 "
          f"and sdad killed and resumed ({smi}):")
    print(f"deployment, Paillier leg beside it: sdad --premix-paillier, "
          f"P={P_DEPLOY_PAILLIER} x d={D_DEPLOY_PAILLIER}, "
          f"{DEPLOY_PAILLIER_BITS}-bit clerks ({smi}):")
    t23 = time.perf_counter()
    # the two deployments share nothing: the Paillier leg's processes run
    # while (a)'s single-process steps leave the host's cores idle
    with ThreadPoolExecutor(1) as pool:
        leg_b = pool.submit(paillier_deployment_phase, dev, smi)
        rec23 = deployment_phase(dev, smi)
        rec23b = leg_b.result()
    print(json.dumps(rec23), flush=True)
    print(json.dumps(rec23b), flush=True)
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")

    # -- 24. the rest of ci.sh ----------------------------------------------
    print(f"ci: ci.sh's other sections through the port's sda-sim on "
          f"{DEVICE}, at ci.sh's sizes and with its assertions ({smi}):")
    t24 = time.perf_counter()
    rec24 = ci_phase(dev, smi)
    rec24["phase_s"] = time.perf_counter() - t24
    print(json.dumps(rec24), flush=True)
    k3_launches["ci"] = rec24["k3_launches"]
    print(f"phase 24: {rec24['phase_s']:.1f} s")

    # -- 25. the examples ----------------------------------------------------
    print(f"examples: the repo's four examples/ as the port's modules on "
          f"{DEVICE}, in this process and as python -m processes ({smi}):")
    t25 = time.perf_counter()
    rec25 = examples_phase(dev, smi)
    rec25["phase_s"] = time.perf_counter() - t25
    print(json.dumps(rec25), flush=True)
    k3_launches["examples"] = rec25["k3_launches"]
    print(f"phase 25: {rec25['phase_s']:.1f} s; the script "
          f"{time.perf_counter() - t_script:.1f} s")

    # -- 8. the record ------------------------------------------------------
    k3_err = max(k3_rec["max_abs_err"], rec10b["k3_max_abs_err"],
                 rec14["k3_window_max_abs_err"],
                 rec15["k3_window_max_abs_err"],
                 rec18["k3_window_max_abs_err"],
                 rec22["k3_window_max_abs_err"],
                 rec22["k3_drills_max_abs_err"], rec23["k3_max_abs_err"],
                 rec25["k3_max_abs_err"], k78_rec["k3_raw_max_abs_err"])
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_mask_share_combine",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/fused_round.cu",
        "replaces": "sda_tpu/fields/pallas_round.py:95",
        "launches": main_launches,
        "launches_streamed": sum(rec15["k1_launches"].values()),
        "launches_bench": rec17["k1_launches"],
        "launches_pod": rec18["k1_launches"],
        "launches_devscale": rec19["k1_launches"],
        "launches_multihost": rec20["k1_launches_round"]
        + rec20["k1_launches_resumed"],
        "launches_fedavg": rec21["k1_launches"],
        "launches_sim": rec22["k1_launches"],
        "launches_ci": rec24["k1_launches"],
        "launches_by_phase": {
            "pod_round": rec18["k1_launches_phase"],
            "devscale": rec19["k1_launches_phase"],
            "multihost": rec20["k1_launches_phase"],
            "fedavg": rec21["k1_launches_phase"],
            "sim": rec22["k1_launches"],
            "ci": rec24["k1_launches"]},
        "max_abs_err": max(max_err["K1"], rec18["k1_shard_max_abs_err"],
                           rec19["k1_shard_max_abs_err"],
                           rec20["k1_shard_max_abs_err"],
                           rec21["k1_shard_max_abs_err"],
                           rec22["k1_shard_max_abs_err"],
                           rec24["k1_shard_max_abs_err"]),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_ms_whole_rounds": whole_ms,
        "instances": k1_instances,
        "accumulate": {
            "replaces": "sda_tpu/mesh/streaming.py:503-505, :719-721",
            "launches_streamed": sum(rec15["k1_launches"].values()),
            "streamed_tile": k1_tile},
    }, {
        "name": "probe_call",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/kernel_probe.cu",
        "replaces": "benchmarks/kernel_probe.py:82",
        "launches": round_k5_launches,
        "probe_launches": probe_launches,
        "max_abs_err": max_err["K5"],
        **{key: k5["full"][key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
        "ms_of": "full",
        "library_ms": lib_ms,
        "library_of": "fold_only",
        "variants": k5,
    }, *_k3_record(k3_rec, rec13, rec15, k3_launches, k3_err, {
        "chacha_round": rec14["seed_word_calls"],
        "streamed_round": rec15["seed_word_calls"],
        "streamed_profile": rec17s["seed_word_calls"],
        "pod_round": rec18["seed_word_calls"],
        "sim": rec22["seed_word_calls"]}), {
        "name": "coordinate_block",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/blockgen.cu",
        "replaces": "sda_tpu/mesh/streaming.py:117",
        "launches": rec15["k6_launches"],
        "launches_of": "the streamed round (phase 15)",
        "launches_by_phase": {
            "streamed_round": rec15["k6_launches"],
            "streamed_oracle": rec15["k6_launches_oracle"],
            "streamed_profile": rec17s["k6_launches"],
            "devscale": rec19["k6_launches"],
            "devscale_phase": rec19["k6_launches_phase"],
            "multihost_streamed": rec20["k6_launches"]},
        "max_abs_err": max(k6_rec["max_abs_err"], rec15["k6_max_abs_err"],
                           rec19["k6_max_abs_err"]),
        **{key: k6_rec[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "share", "shape",
            "ptxas", "bound_ms_row_loop")},
        "library_ms": None,
    }, {
        "name": "reveal",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/reveal.cu",
        "replaces": "sda_tpu/fields/sharing.py:141",
        "launches": main_k7_launches,
        "launches_of": "the flagship round (phase 5)",
        "launches_by_phase": {
            "streamed_round": rec15["k7_launches"],
            "streamed_profile": rec17s["k7_launches"],
            "pod_round": rec18["k7_launches"],
            "devscale": rec19["k7_launches"],
            "devscale_phase": rec19["k7_launches_phase"],
            "fedavg": rec21["k7_launches"],
            "sim": rec22["k7_launches"]},
        "max_abs_err": k78_rec["k7_max_abs_err"],
        **{key: k78_rec["k7_timed"][0][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "share")},
        "shape": [k78_rec["k7_timed"][0][key] for key in ("r", "B", "k",
                                                          "d")],
        "timed": k78_rec["k7_timed"],
        "ptxas": k78_rec["ptxas"]["K7"],
        "library_ms": None,
    }, {
        "name": "residues_int32",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/residues.cu",
        "replaces": "sda_tpu/fields/fastfield.py:89",
        "launches": sum(rec18["k8_launches"].values()),
        "launches_of": "the pod rounds (phase 18)",
        "launches_by_phase": {
            "flagship_round": 0,
            "streamed_round": rec15["k8_launches"],
            "pod_round": rec18["k8_launches"],
            "devscale": rec19["k8_launches"],
            "devscale_phase": rec19["k8_launches_phase"],
            "fedavg": rec21["k8_launches"],
            "sim": rec22["k8_launches"]},
        "max_abs_err": k78_rec["k8_max_abs_err"],
        **{key: k78_rec["k8"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "share", "shape",
            "dtype", "library_ms", "no_slower_than_library")},
        "library_of": "torch.remainder(x, p).to(torch.int32)",
        "ptxas": k78_rec["ptxas"]["K8"],
    }, {
        "name": "premix",
        "route": "cuda",
        "source": "sda_tpu_torch/fields/csrc/montgomery.cu",
        "replaces": "sda_tpu/crypto/paillier_tpu.py:137",
        "launches": sum(k4_launches.values()),
        "launches_by_phase": k4_launches,
        "max_abs_err": max(k4_rec["max_abs_err"], rec16b["k4_max_abs_err"],
                           rec23b["max_abs_err"]),
        "premixed_in_sdad": rec23b["premix_counters"],
        **{key: k4_rec[key] for key in (
            "launches_by_op", "ms", "ms_of",
            "wrapper_ms", "ms_wide", "bound_ms_wide", "ms_wide_of",
            "plain_ms", "plain_ms_of", "plain_ms_flagship", "bound_ms",
            "bound_by", "host_ms", "host_of")},
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
