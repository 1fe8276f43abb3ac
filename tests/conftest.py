"""Test configuration: the tests run on the CPU, with an 8-device virtual
CPU mesh for the multi-device sharding logic (SURVEY.md §4). What needs the
GPU is exercised by chip_smoke.py.
"""

import os

# must be set before the first backend initialization
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mumemto_tpu import refbuilder  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def mutated_collection(rng, n_docs, base_len=250, n_mut=8, insert_rep=None):
    """A collection of lightly mutated copies of one base sequence —
    guarantees plenty of shared maximal matches."""
    base = rand_seq(rng, base_len)
    docs = []
    for _ in range(n_docs):
        s = list(base)
        for _ in range(int(rng.integers(1, n_mut))):
            i = int(rng.integers(0, len(s)))
            s[i] = rng.choice(list("ACGT"))
        body = "".join(s)
        if insert_rep is not None:
            for _ in range(int(rng.integers(1, 4))):
                cut = int(rng.integers(0, len(body)))
                body = body[:cut] + insert_rep + body[cut:]
        docs.append([body])
    return docs


@pytest.fixture
def collection(rng):
    return mutated_collection(rng, 3)


def build(docs, use_revcomp=True):
    return refbuilder.build_from_sequences(docs, use_revcomp=use_revcomp)
