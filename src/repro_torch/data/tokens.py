"""Synthetic token streams for the LM-scale examples and smoke tests.

A small hidden Markov generator so the streams are learnable (loss decreases
during the end-to-end example run) rather than uniform noise.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def make_token_stream(rng: np.random.Generator, vocab: int, length: int,
                      n_states: int = 8) -> np.ndarray:
    """HMM over n_states latent states, each emitting a distinct vocab band."""
    trans = rng.dirichlet(np.ones(n_states) * 0.5, size=n_states)
    band = vocab // n_states
    state = int(rng.integers(n_states))
    out = np.empty(length, dtype=np.int32)
    states = np.empty(length, dtype=np.int32)
    for i in range(length):
        states[i] = state
        state = int(rng.choice(n_states, p=trans[state]))
    offsets = rng.integers(0, max(band, 1), size=length)
    out = (states * band + offsets).astype(np.int32) % vocab
    return out


def token_batches(stream: np.ndarray, batch: int, seq_len: int,
                  rng: np.random.Generator) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (tokens, labels) pairs of shape (batch, seq_len) forever."""
    n_positions = len(stream) - seq_len - 1
    while True:
        starts = rng.integers(0, n_positions, size=batch)
        toks = np.stack([stream[s:s + seq_len] for s in starts])
        labs = np.stack([stream[s + 1:s + seq_len + 1] for s in starts])
        yield toks, labs
