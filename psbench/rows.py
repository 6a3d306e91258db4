"""Criteo-shaped rows from a seed: the one generator that every mix reads.

A row is a label and one id in each field: the configuration's integer
fields (bucketized) and categorical fields, each with its own vocabulary.
Ids follow a power law of the configuration's exponent, truncated at the
field's vocabulary (the continuous inverse transform, floored). Labels come
from a hidden logistic model over the ids, so a model that learns reaches
an AUC above 0.5.

Batch ``index`` of stream ``stream`` is drawn from its own generator,
seeded by ``(seed, stream, index)``: any batch can be made again alone, and
every seed gives the same sizes."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from psbench.reference.hashing import hash_keys, splitmix64

# salt of the hidden label model, apart from every field's table salt
_LABEL_SALT = np.uint64(0x5EED_1AB3_1000_0000)


def seed_words(seed: int) -> list[int]:
    """Any whole number as non-negative words for ``SeedSequence``."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


@dataclass
class Rows:
    labels: np.ndarray  # (B,) float32 in {0, 1}
    ids: np.ndarray  # (B, F) int64, ids[:, f] < vocab[f]


class CriteoRows:
    """The generator of one configuration's rows."""

    def __init__(self, cfg: dict):
        self.vocab = np.array(
            [cfg["integer_buckets"]] * cfg["integer_fields"]
            + list(cfg["categorical_vocab"]),
            dtype=np.int64,
        )
        self.fields = len(self.vocab)
        self.exponent = float(cfg["zipf_exponent"])
        lab = cfg["label_model"]
        self.bias, self.scale = float(lab["bias"]), float(lab["scale"])

    def _ids(self, rng: np.random.Generator, n: int) -> np.ndarray:
        a = self.exponent
        u = rng.random((n, self.fields))
        top = (self.vocab + 1.0) ** (1.0 - a)
        x = (1.0 - u * (1.0 - top)) ** (1.0 / (1.0 - a))
        return np.minimum(x.astype(np.int64) - 1, self.vocab - 1)

    def batch(self, seed: int, stream: int, index: int, size: int) -> Rows:
        rng = np.random.default_rng([*seed_words(seed), int(stream), int(index)])
        ids = self._ids(rng, size)
        salt = np.arange(self.fields, dtype=np.uint64)
        with np.errstate(over="ignore"):
            h = splitmix64(ids.astype(np.uint64) ^ (salt + _LABEL_SALT))
        w = ((h >> np.uint64(11)).astype(np.float64) * 2.0**-53 - 0.5) * self.scale
        p = 1.0 / (1.0 + np.exp(-(self.bias + w.sum(axis=1))))
        labels = (rng.random(size) < p).astype(np.float32)
        return Rows(labels, ids)

    def slots(self, size: int) -> np.ndarray:
        """The field of every entry of a flattened (size, F) id block."""
        return np.tile(np.arange(self.fields, dtype=np.int64), size)

    def global_keys(self, rows: Rows, num_keys: int) -> np.ndarray:
        """(B, F) table rows of ``rows``' ids, hashed with the field as salt
        into ``[1, num_keys)``."""
        b = rows.ids.shape[0]
        return hash_keys(rows.ids.ravel(), num_keys, self.slots(b)).reshape(b, -1)
