"""ChaCha20-based deterministic mask PRGs (host-side, vectorized numpy).

The reference's ChaCha masking scheme derives an O(d) mask from a <=256-bit
seed so participants upload O(1) mask data (client/src/crypto/masking/
chacha.rs:24-77, via rand 0.3's ChaChaRng). TWO streams are implemented over
the shared ChaCha20 block function, selected by the wire-visible ``prg`` tag
on the scheme (protocol.crypto.ChaChaMasking):

``CHACHA_PRG_RAND03`` (the default — what the bare Rust wire shape means):
the exact rand-0.3 ``ChaChaRng::from_seed(&[u32])`` + ``gen_range(0, m)``
stream the reference's masker draws, so a round mixed with a Rust peer
reveals the CORRECT aggregate. Per rand 0.3's chacha.rs and
distributions/range.rs:

- key: seed words into key words 0..len-1, remaining words 0; block counter
  is 128-bit (words 12..15, from 0) — identical to a word-12 counter below
  2^32 blocks; 20 rounds;
- draw stream: ``next_u64`` = (FIRST word as high) << 32 | (second as low);
- sample in [0, m): accept v < zone where zone = u64::MAX - u64::MAX % m,
  then v % m.

``CHACHA_PRG_V1`` (opt-in, tagged on the wire): sda-tpu's own versioned
spec — same block function, but u64 draws take word[2i] as the LOW half and
the acceptance zone is floor(2^64/m)*m (inclusive-below), which also
differs from rand 0.3 on power-of-two moduli.

Both participant (mask generation) and recipient (mask re-expansion — the
recipient hot loop, receive.rs:102-118) use the same expansion, so the
protocol stays self-consistent; native C++ implementations of both specs
live in sda_tpu_torch/native, device (jax) implementations in fields.chacha_jax.
"""

from __future__ import annotations

import secrets as _secrets
from typing import List, Sequence

import numpy as np

CHACHA_PRG_V1 = "sda-tpu/chacha20-prg/v1"
#: the stream implied by the bare Rust wire shape (crypto.rs:53 documents
#: the scheme as `rand::chacha::ChaChaRng`); protocol.crypto pins the same
#: literals (duplicated to keep the wire layer import-free; a test asserts
#: they match)
CHACHA_PRG_RAND03 = "rand-0.3/chacharng"

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def random_seed(seed_bitsize: int) -> List[int]:
    """Fresh OS-random seed of ceil(seed_bitsize/32) u32 words (chacha.rs:29-34)."""
    words = (seed_bitsize + 31) // 32
    if words > 8:
        raise ValueError("seed_bitsize > 256 unsupported: ChaCha20 keys hold 256 bits")
    return [int.from_bytes(_secrets.token_bytes(4), "little") for _ in range(words)]


def _rotl(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(state, a, b, c, d):
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 7)


def chacha_block_words(seed: Sequence[int], counter0: int, nblocks: int) -> np.ndarray:
    """[nblocks, 16] u32 keystream words for block counters counter0..+nblocks.

    Vectorized: all blocks advance through the 20 rounds simultaneously.
    """
    if len(seed) > 8:
        raise ValueError(
            f"seed has {len(seed)} words; ChaCha20 keys hold at most 8 "
            "(256 bits) — longer seeds would silently lose entropy"
        )
    key = np.zeros(8, dtype=np.uint32)
    for i, w in enumerate(seed):
        key[i] = np.uint32(w & 0xFFFFFFFF)
    init = np.zeros((16, nblocks), dtype=np.uint32)
    init[0:4] = _CONSTANTS[:, None]
    init[4:12] = key[:, None]
    init[12] = (np.arange(counter0, counter0 + nblocks)).astype(np.uint32)
    state = init.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            # column rounds
            _quarter(state, 0, 4, 8, 12)
            _quarter(state, 1, 5, 9, 13)
            _quarter(state, 2, 6, 10, 14)
            _quarter(state, 3, 7, 11, 15)
            # diagonal rounds
            _quarter(state, 0, 5, 10, 15)
            _quarter(state, 1, 6, 11, 12)
            _quarter(state, 2, 7, 8, 13)
            _quarter(state, 3, 4, 9, 14)
        state += init
    return state.T  # [nblocks, 16]


def expand_mask(seed: Sequence[int], dimension: int, modulus: int) -> np.ndarray:
    """Deterministic mask vector in [0, m)^d from a seed (the PRG expansion).

    Rejection sampling on u64 draws; each 16-word block yields 8 draws.
    """
    if modulus <= 0 or modulus >= (1 << 62):
        raise ValueError("modulus out of range")
    m = np.uint64(modulus)
    zone = np.uint64(((1 << 64) // modulus) * modulus - 1)  # accept v <= zone
    out = np.empty(dimension, dtype=np.int64)
    filled = 0
    counter = 0
    # over-draw slightly; rejection probability is < m/2^64
    while filled < dimension:
        need = dimension - filled
        nblocks = max(1, -(-need // 8) + 1)
        words = chacha_block_words(seed, counter, nblocks).reshape(-1)
        counter += nblocks
        lo = words[0::2].astype(np.uint64)
        hi = words[1::2].astype(np.uint64)
        v = (hi << np.uint64(32)) | lo
        v = v[v <= zone]
        take = min(need, v.shape[0])
        out[filled : filled + take] = (v[:take] % m).astype(np.int64)
        filled += take
    return out


def expand_mask_rand03(seed: Sequence[int], dimension: int, modulus: int) -> np.ndarray:
    """The exact rand-0.3 ChaChaRng mask stream (chacha.rs:37-41, 57-77).

    ``ChaChaRng::from_seed(&seed)`` then ``gen_range(0_i64, modulus)`` per
    element: u64 draws assemble the FIRST keystream word as the HIGH half
    (rand 0.3's default ``Rng::next_u64``), rejection accepts
    ``v < u64::MAX - u64::MAX % m`` (distributions/range.rs), result is
    ``v % m``. Each rejected draw consumes its two words, so the word
    pairing is positional and the expansion vectorizes exactly.
    """
    if modulus <= 0 or modulus >= (1 << 62):
        raise ValueError("modulus out of range")
    m = np.uint64(modulus)
    u64_max = (1 << 64) - 1
    zone_excl = np.uint64(u64_max - u64_max % modulus)  # accept v < zone
    out = np.empty(dimension, dtype=np.int64)
    filled = 0
    counter = 0
    while filled < dimension:
        need = dimension - filled
        nblocks = max(1, -(-need // 8) + 1)
        words = chacha_block_words(seed, counter, nblocks).reshape(-1)
        counter += nblocks
        hi = words[0::2].astype(np.uint64)
        lo = words[1::2].astype(np.uint64)
        v = (hi << np.uint64(32)) | lo
        v = v[v < zone_excl]
        take = min(need, v.shape[0])
        out[filled : filled + take] = (v[:take] % m).astype(np.int64)
        filled += take
    return out


_EXPANDERS = {
    CHACHA_PRG_V1: expand_mask,
    CHACHA_PRG_RAND03: expand_mask_rand03,
}


def expand_mask_for(
    prg: str, seed: Sequence[int], dimension: int, modulus: int
) -> np.ndarray:
    """PRG-tag-dispatched expansion; unknown tags fail loudly — an
    unrecognized stream must never silently alias another one (that is
    exactly the wrong-aggregate hazard the tag exists to prevent)."""
    try:
        fn = _EXPANDERS[prg]
    except KeyError:
        raise ValueError(f"unknown ChaCha PRG {prg!r}") from None
    return fn(seed, dimension, modulus)
