"""The ML-1M-scale data of the PFCN cells, written from the seed.

Users and their attributes are the real ``ml-1M.user`` (a copy beside the
configuration). The ratings are synthetic, at RecBole's published ml-1m
scale, by the recipe of the JAX package's ``bench.py``: unique random
(user, item) pairs, a rating of 1 to 5 each. Every seed gives the same
number of users, items and ratings.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .manifest import BENCH_DIR


def user_file(data):
    return os.path.join(BENCH_DIR, data["user_file"])


def read_users(data):
    """The user file as ``{column: int array}``, header names without their
    types."""
    with open(user_file(data)) as f:
        header = [h.split(":")[0] for h in f.readline().rstrip("\n").split("\t")]
        rows = np.loadtxt(f, delimiter="\t", dtype=np.float64, ndmin=2)
    return {name: rows[:, j].astype(np.int64) for j, name in enumerate(header)}


def ratings(data, seed):
    """(user, item, rating) arrays: ``n_inter`` unique pairs over
    ``n_users`` × ``n_items``, ids from 1."""
    n_users, n_items, n_inter = data["n_users"], data["n_items"], data["n_inter"]
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, n_users * n_items, int(n_inter * 1.35)))
    rng.shuffle(keys)
    if len(keys) < n_inter:
        raise ValueError(f"drew {len(keys)} unique pairs, fewer than {n_inter}")
    keys = keys[:n_inter]
    return keys // n_items + 1, keys % n_items + 1, rng.randint(1, 6, n_inter)


def write(root, name, data, seed):
    """Write ``<root>/<name>/<name>.inter`` and ``.user``; returns the
    (user, item, rating) arrays."""
    ddir = os.path.join(root, name)
    os.makedirs(ddir, exist_ok=True)
    u, i, r = ratings(data, seed)
    rows = np.stack([u, i, r], axis=1).astype(str).tolist()
    with open(os.path.join(ddir, f"{name}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\n")
        f.write("\n".join(map("\t".join, rows)))
        f.write("\n")
    shutil.copyfile(user_file(data), os.path.join(ddir, f"{name}.user"))
    return u, i, r


def attribute_classes(data, attrs):
    """Per attribute: a lookup from raw value to class (sorted values →
    0..k-1) and the number of classes k."""
    users = read_users(data)
    out = {}
    for attr in attrs:
        values = np.unique(users[attr])
        lut = np.zeros(int(values.max()) + 1, dtype=np.int64)
        lut[values] = np.arange(len(values))
        out[attr] = (lut, len(values))
    return out
