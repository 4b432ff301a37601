"""The port of the JAX package's ``datasets/movielens.py`` (a copy: the port imports
nothing of the JAX package). MovieLens recommender dataset
(parity: the reference's v2/dataset/movielens.py — used by
the recommender book test).

Samples: (user_id, gender, age, job, movie_id, category_ids, title_ids,
rating). Real data: the standard ``ml-1m.zip`` under DATA_HOME/movielens
('::'-separated users.dat/movies.dat/ratings.dat, parsed like the
reference's __initialize_meta_info__; every 10th rating held out for
test). Synthetic surrogate otherwise, with latent-factor structure so
the recommender model can actually fit.
"""
from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.datasets import common

# the reference's age buckets (movielens.py age_table)
AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]

MAX_USER_ID = 944
MAX_MOVIE_ID = 1683
NUM_JOBS = 21
NUM_AGES = 7
NUM_CATEGORIES = 18
TITLE_VOCAB = 1000

_rs = np.random.RandomState(0xFEED)
_user_f = _rs.randn(MAX_USER_ID + 1, 4)
_movie_f = _rs.randn(MAX_MOVIE_ID + 1, 4)


_META_CACHE = {}


def _real_meta():
    """Parsed (users, movies, genre_idx, title_idx) when ml-1m.zip is
    present (cached — the zip is decoded once per archive file). The key
    is (resolved path, mtime) so a DATA_HOME switch or a zip appearing /
    replaced mid-process naturally misses the cache."""
    path = _archive()
    if not os.path.exists(path):
        return None
    key = (os.path.realpath(path), os.path.getmtime(path))
    if key not in _META_CACHE:
        _META_CACHE.clear()   # at most one archive's meta kept resident
        _META_CACHE[key] = _load_meta()
    return _META_CACHE[key]


def max_user_id():
    meta = _real_meta()
    return max(meta[0]) if meta else MAX_USER_ID


def max_movie_id():
    meta = _real_meta()
    return max(meta[1]) if meta else MAX_MOVIE_ID


def max_job_id():
    meta = _real_meta()
    if meta:
        return max(job for _, _, job in meta[0].values())
    return NUM_JOBS - 1


def num_categories():
    meta = _real_meta()
    return len(meta[2]) if meta else NUM_CATEGORIES


def title_vocab_size():
    meta = _real_meta()
    return len(meta[3]) if meta else TITLE_VOCAB


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            uid = int(rng.randint(1, MAX_USER_ID + 1))
            mid = int(rng.randint(1, MAX_MOVIE_ID + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, NUM_AGES))
            job = int(rng.randint(0, NUM_JOBS))
            cats = rng.randint(0, NUM_CATEGORIES,
                               size=rng.randint(1, 4)).astype(np.int64)
            title = rng.randint(0, TITLE_VOCAB,
                                size=rng.randint(2, 6)).astype(np.int64)
            score = float(np.clip(
                3.0 + _user_f[uid] @ _movie_f[mid] * 0.6 + rng.randn() * 0.2,
                1.0, 5.0))
            yield (uid, gender, age, job, mid, cats.tolist(), title.tolist(),
                   np.array([score], np.float32))

    return reader


def _archive():
    return common.dataset_path("movielens", "ml-1m.zip")


def _load_meta():
    """Parse users.dat / movies.dat from the zip (ref movielens.py
    MovieInfo/UserInfo): genre ids from the sorted genre vocabulary,
    title word ids from the sorted title-token vocabulary."""
    import zipfile

    users, movies = {}, {}
    genres, title_words = set(), set()
    with zipfile.ZipFile(_archive()) as zf:
        root = zf.namelist()[0].split("/")[0]
        with zf.open(f"{root}/movies.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                mid, title, cats = line.strip().split("::")
                cats = cats.split("|")
                toks = title.lower().split()
                genres.update(cats)
                title_words.update(toks)
                movies[int(mid)] = (cats, toks)
        with zf.open(f"{root}/users.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, gender, age, job, _zip = line.strip().split("::")
                users[int(uid)] = (int(gender == "M"),
                                   AGE_TABLE.index(int(age)), int(job))
    genre_idx = {g: i for i, g in enumerate(sorted(genres))}
    title_idx = {t: i for i, t in enumerate(sorted(title_words))}
    return users, movies, genre_idx, title_idx


def _real(is_train):
    import zipfile

    users, movies, genre_idx, title_idx = _real_meta()

    def reader():
        with zipfile.ZipFile(_archive()) as zf:
            root = zf.namelist()[0].split("/")[0]
            with zf.open(f"{root}/ratings.dat") as f:
                for i, line in enumerate(
                        f.read().decode("latin1").splitlines()):
                    if (i % 10 == 0) == is_train:
                        continue
                    uid, mid, rating, _ts = line.strip().split("::")
                    uid, mid = int(uid), int(mid)
                    if uid not in users or mid not in movies:
                        continue
                    gender, age, job = users[uid]
                    cats, toks = movies[mid]
                    yield (uid, gender, age, job, mid,
                           [genre_idx[c] for c in cats],
                           [title_idx[t] for t in toks],
                           np.array([float(rating)], np.float32))

    return reader


def train(n_synthetic: int = 4096):
    if os.path.exists(_archive()):
        return _real(is_train=True)
    return _synthetic(n_synthetic, seed=51)


def test(n_synthetic: int = 512):
    if os.path.exists(_archive()):
        return _real(is_train=False)
    return _synthetic(n_synthetic, seed=52)
