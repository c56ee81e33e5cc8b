"""Per-request sampling: host-side parameters + on-device token selection.

``SamplingParams`` travels with every request (temperature / top-k /
top-p / seed / stop tokens); the engine's step closures call
``sample_tokens`` on the logits' device, next to the logits, so the
full vocab distribution never travels to the host.

Determinism contract (the JAX package's): the random stream of the
token at absolute sequence index ``i`` is keyed by
``fold_in(PRNGKey(seed), i)`` — a pure function of the request's seed
and the token position.  Batch composition, bucket padding, preemption
(recompute replays the same positions) and swap-in (positions restored
exactly) never change a sampled stream.  ``temperature == 0`` is exact
argmax (greedy, first index on ties, as ``jnp.argmax``) and ignores the
seed.

The keys and draws are JAX's own bits: ``threefry2x32`` below is the
Threefry-2x32 hash of ``jax.random`` (default ``threefry2x32`` PRNG,
``jax_threefry_partitionable=True`` counter layout) written in plain
torch integer ops — uint32 words held in int64 and masked with
``0xFFFFFFFF`` after every addition and shift, so the CPU and the card
compute the same bits.  ``gumbel`` is ``jax.random.gumbel``'s default
``mode="low"``: ``-log(-log(u))`` over one uniform draw per element,
the uniform built from the top 23 random bits exactly as
``jax.random.uniform`` builds it (bit-equal; only ``log`` may differ by
an ulp).  So a sampled token equals the JAX engine's token for token,
and the same bits give the legacy loop's
``jax.random.categorical(PRNGKey(i), logits)`` (``categorical``).

Sampling is Gumbel-max over the filtered logits: top-k keeps the k
highest logits, top-p keeps the smallest prefix of the sorted
distribution whose mass reaches p (always at least the top token), and
``argmax(logits / T + gumbel)`` draws from the renormalised categorical.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG = -1e30
_M32 = 0xFFFFFFFF
# Threefry-2x32 rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.  Defaults reproduce greedy decoding."""
    temperature: float = 0.0      # 0 => greedy argmax (seed ignored)
    top_k: int = 0                # 0 => no top-k filter
    top_p: float = 1.0            # 1.0 => no nucleus filter
    seed: int = 0                 # per-request PRNG stream
    stop: tuple[int, ...] = ()    # stop/eos token ids (early termination)

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0: {self.top_k}")
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))

    @property
    def stop_set(self) -> frozenset[int]:
        return frozenset(self.stop)


GREEDY = SamplingParams()


@dataclass
class SamplingRows:
    """Padded per-row operands of one step; padded rows are greedy.
    ``seeds`` holds the uint32 seed in int64 (torch's uint32 support is
    thin)."""
    seeds: np.ndarray             # (B,) int64, 0 <= seed < 2**32
    temps: np.ndarray             # (B,) float32
    top_k: np.ndarray             # (B,) int32
    top_p: np.ndarray             # (B,) float32

    @property
    def greedy(self) -> bool:
        return not bool((self.temps > 0).any())

    def as_args(self, device) -> tuple:
        """The four operands on ``device``; four ``None`` when every row
        is greedy (the host knows it, so the step skips the draws)."""
        if self.greedy:
            return (None,) * 4
        return tuple(torch.from_numpy(a).to(device)
                     for a in (self.seeds, self.temps, self.top_k,
                               self.top_p))


def sampling_rows(reqs, batch: int) -> SamplingRows:
    """Pack each request's SamplingParams into padded (B,) arrays."""
    rows = SamplingRows(np.zeros(batch, np.int64),
                        np.zeros(batch, np.float32),
                        np.zeros(batch, np.int32),
                        np.ones(batch, np.float32))
    for i, r in enumerate(reqs):
        sp = r.sampling
        rows.seeds[i] = sp.seed & _M32
        rows.temps[i] = sp.temperature
        rows.top_k[i] = sp.top_k
        rows.top_p[i] = sp.top_p
    return rows


# ---------------------------------------------------------------------------
# Threefry-2x32 and the draws built on it


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2)
    under key (k1, k2): int64 tensors holding uint32 values, broadcast
    together.  Returns the two output words.

    Sums mod 2**32 depend only on their operands' low 32 bits, so x1
    runs unmasked (it gains about a bit a round, far below 2**63) and
    is masked where its bits move: into x2 (masked every round, before
    its next rotation) and at the end."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & _M32
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & _M32
    return x1 & _M32, x2


def token_key(seed: torch.Tensor, index: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(PRNGKey(seed), index)`` for (B,) seeds and positions:
    the key of the token at absolute position ``index``.  PRNGKey of a
    uint32 seed is the word pair (0, seed); folding in ``index`` hashes
    the counter pair (0, index) under it."""
    seed = seed.long() & _M32
    index = index.long() & _M32
    zero = torch.zeros_like(seed)
    return threefry2x32(zero, seed, zero, index)


def random_bits(k1: torch.Tensor, k2: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable layout):
    element j of the row-major flattening hashes the counter pair
    (j >> 32, j & 0xFFFFFFFF); its bits are the two words XORed.  ``k1``
    and ``k2`` broadcast against ``shape``."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=k1.device).reshape(shape)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return b1 ^ b2


def uniform(k1, k2, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``
    — the low-mode Gumbel's draw: 23 random mantissa bits under the
    exponent of 1.0, minus 1.0, then scaled into [tiny, 1)."""
    bits = random_bits(k1, k2, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # maxval - minval = 1 - tiny is 1.0 in float32; tiny is a float32
    # value, so these Python scalars act in float32 exactly as JAX's
    return torch.clamp_min(f * 1.0 + _TINY, _TINY)


def gumbel(k1, k2, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default "low"
    mode: ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(k1, k2, shape)))


def categorical(seed: int, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(PRNGKey(seed), logits)`` over the last
    axis of (B, V) float32 logits: one Gumbel draw of the whole (B, V)
    shape, then argmax.  Returns (B,) int64."""
    dev = logits.device
    k1 = torch.zeros((), dtype=torch.int64, device=dev)
    k2 = torch.tensor(seed & _M32, dtype=torch.int64, device=dev)
    g = gumbel(k1, k2, tuple(logits.shape))
    return torch.argmax(g + logits.float(), dim=-1)


# ---------------------------------------------------------------------------
# filtering and selection


def filter_rows(logits: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Each row's logits masked to its top-k / nucleus support (NEG
    outside): (B, V) float32, (B,) int, (B,) float32.  The sort is
    stable and descending, so tied logits keep index order, as
    ``jnp.argsort(-x)``."""
    v = logits.shape[-1]
    ranked, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    ranks = torch.arange(v, device=logits.device)[None, :]
    k = top_k.long()[:, None]
    keep = (k <= 0) | (ranks < k)
    # top-p: keep the smallest prefix with cumulative mass >= p; the
    # "- prob" keeps every token whose cumsum FIRST reaches p (so the
    # top token always survives even when p < its probability)
    probs = torch.softmax(ranked, dim=-1)
    keep &= torch.cumsum(probs, dim=-1) - probs < top_p.float()[:, None]
    masked = torch.where(keep, ranked, torch.full_like(ranked, NEG))
    return torch.empty_like(logits).scatter_(1, order, masked)


def sample_tokens(logits: torch.Tensor, index: torch.Tensor | None = None,
                  seeds=None, temps=None, top_k=None, top_p=None
                  ) -> torch.Tensor:
    """Select one token per row on the logits' device: (B, V) -> (B,)
    int64.

    index (B,) absolute sequence position of the token being chosen
    (the PRNG stream position); seeds/temps/top_k/top_p (B,) per-row
    sampling operands.  Without operands (``temps is None``) every row
    is greedy."""
    greedy_tok = torch.argmax(logits, dim=-1)
    if temps is None:
        return greedy_tok
    lf = logits.float()
    safe_t = torch.clamp(temps.float(), min=1e-6)[:, None]
    filtered = filter_rows(lf / safe_t, top_k, top_p)
    k1, k2 = token_key(seeds, index)
    g = gumbel(k1[:, None], k2[:, None], (lf.shape[-1],))
    sampled = torch.argmax(filtered + g, dim=-1)
    return torch.where(temps > 0, sampled, greedy_tok)


# ---------------------------------------------------------------------------
# prompt-lookup drafting (speculative decoding's draft model)


def prompt_lookup_draft(seq: np.ndarray, k: int, max_ngram: int = 3
                        ) -> np.ndarray:
    """Draft up to ``k`` tokens by n-gram lookup in the sequence itself,
    on the host: the most recent earlier occurrence of the sequence's
    final n-gram (longest n first) proposes the tokens that followed it
    (prompt-lookup decoding, no second model).  Returns an empty array
    when nothing matches."""
    seq = np.asarray(seq)
    ln = len(seq)
    if k <= 0 or ln < 2:
        return np.empty(0, np.int32)
    for n in range(min(max_ngram, ln - 1), 0, -1):
        pat = seq[ln - n:]
        # every window that ends before the suffix
        wins = np.lib.stride_tricks.sliding_window_view(seq[:-1], n)
        hits = np.nonzero((wins == pat).all(axis=1))[0]
        for i in hits[::-1]:                 # most recent first
            cont = seq[i + n:i + n + k]
            if len(cont):
                return np.asarray(cont, np.int32)
    return np.empty(0, np.int32)
