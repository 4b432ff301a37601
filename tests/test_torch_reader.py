"""The port's readers, datasets and DataFeeder held against the JAX
package's on the CPU.

- ``reader.decorator``: each decorator's output on the same inputs
  equals the JAX decorator's, exactly: ``map_readers``, ``shuffle``
  with a seed (Python's ``random.Random`` in both), ``chain``,
  ``compose`` (aligned, the ragged-tail error, ``check_alignment=False``),
  ``buffered``, ``firstn``, ``xmap_readers`` (order kept with
  ``order=True``; the same multiset without), ``cache``, ``batch``
  (with and without ``drop_last``) and ``bucket_by_sequence_length``
  (padding lists and numpy rows, oversize dropped or raising).
- ``device_buffered`` with ``device="cpu"``: the items as tensors on the
  CPU, LoD kept, other leaves passed through; with no device and no card
  it raises (the card is the default). The card case is in
  ``tests/test_torch_trainer_cuda.py``.
- ``reader.creator``: ``np_array``, ``text_file``; ``recordio`` and
  ``cloud_reader`` raise naming ROADMAP A11.
- ``datasets``: the first 64 samples of each of the thirteen datasets
  but cifar (``tests/test_torch_image.py``): imdb, uci_housing, mnist,
  imikolov, sentiment, wmt14, movielens, conll05, ctr, mq2007 (its three
  formats), flowers and voc2012, train and test splits, equal the JAX
  modules', from the fixture files under tests/fixtures/datasets and
  from the synthetic surrogates (an empty DATA_HOME): arrays bit-equal,
  labels and ids equal; so are their dictionaries and size tables.
- ``reader.provider``: each slot type's conversion, shuffled and
  buffered, and the range error, as the JAX ``provider``.
- ``DataFeeder``: dense, LoD and nested-LoD slots give the JAX feeder's
  arrays, dtypes and LoD offsets.
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu import data_feeder as jfeeder
from paddle_tpu import datasets as jds
from paddle_tpu import layers as jlayers
from paddle_tpu import reader as jreader
from paddle_tpu.datasets import common as jcommon
from paddle_tpu.datasets import imdb as jimdb
from paddle_tpu.datasets import mnist as jmnist
from paddle_tpu.datasets import uci_housing as juci
from paddle_tpu.framework import program as jprog
from paddle_tpu.reader import decorator as jdec
from paddle_tpu.reader import provider as jprovider

import paddle_tpu_torch as pt
from paddle_tpu_torch import data_feeder as tfeeder
from paddle_tpu_torch import datasets as tds
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.datasets import common as tcommon
from paddle_tpu_torch.datasets import imdb as timdb
from paddle_tpu_torch.datasets import mnist as tmnist
from paddle_tpu_torch.datasets import uci_housing as tuci
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.reader import creator as tcreator
from paddle_tpu_torch.reader import decorator as tdec
from paddle_tpu_torch.reader import provider as tprovider

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "datasets")


def _samples(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 50, int(rng.randint(1, 9))).tolist(),
             int(rng.randint(0, 2))) for _ in range(n)]


def _reader(items):
    return lambda: iter(items)


def _same(a, b):
    """Equal nested samples: lists, tuples, ints and numpy arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a == b


DATA = _samples()
NUMS = list(range(17))

DECORATORS = {
    "map_readers": lambda d: d.map_readers(lambda a, b: a * 10 + b,
                                           _reader(NUMS),
                                           _reader(NUMS[::-1])),
    "shuffle": lambda d: d.shuffle(_reader(DATA), 7, seed=3),
    "shuffle_one_buffer": lambda d: d.shuffle(_reader(DATA), 100, seed=11),
    "chain": lambda d: d.chain(_reader(NUMS[:5]), _reader(DATA[:4])),
    "compose": lambda d: d.compose(_reader(DATA[:6]), _reader(NUMS[:6])),
    "compose_unchecked": lambda d: d.compose(_reader(DATA[:6]),
                                             _reader(NUMS[:4]),
                                             check_alignment=False),
    "buffered": lambda d: d.buffered(_reader(DATA), 3),
    "firstn": lambda d: d.firstn(_reader(DATA), 5),
    "xmap_ordered": lambda d: d.xmap_readers(lambda s: (s[1], len(s[0])),
                                             _reader(DATA), 3, 4, order=True),
    "cache": lambda d: d.cache(_reader(DATA)),
    "batch": lambda d: d.batch(_reader(DATA), 5),
    "batch_drop_last": lambda d: d.batch(_reader(DATA), 5, drop_last=True),
    "bucket": lambda d: d.bucket_by_sequence_length(
        _reader(DATA), boundaries=(3, 6, 8), batch_size=3, pad_value=-1),
    "bucket_numpy": lambda d: d.bucket_by_sequence_length(
        _reader([(np.asarray(w, np.int64).reshape(-1, 1), y)
                 for w, y in DATA]), boundaries=(4, 8), batch_size=4),
    "bucket_drop": lambda d: d.bucket_by_sequence_length(
        _reader(DATA), boundaries=(4,), batch_size=2, drop_oversize=True),
}


@pytest.mark.parametrize("name", list(DECORATORS))
def test_decorator_matches_jax(name):
    want = list(DECORATORS[name](jdec)())
    got = list(DECORATORS[name](tdec)())
    _same(got, want)
    if name == "cache":   # the second pass replays the cached samples
        reader = DECORATORS[name](tdec)
        assert list(reader()) == list(reader()) == want


def test_unordered_xmap_and_raises_match_jax():
    def mapper(s):
        return sum(s[0]) + s[1]

    want = sorted(jdec.xmap_readers(mapper, _reader(DATA), 4, 2)())
    assert sorted(tdec.xmap_readers(mapper, _reader(DATA), 4, 2)()) == want
    with pytest.raises(tdec.ComposeNotAligned):
        list(tdec.compose(_reader(NUMS[:3]), _reader(NUMS[:4]))())
    with pytest.raises(ValueError, match="exceeds the last bucket"):
        list(tdec.bucket_by_sequence_length(_reader(DATA), (2,), 4)())

    def broken():
        yield 1
        raise RuntimeError("reader failed")

    for dec in (lambda r: tdec.buffered(r, 2),
                lambda r: tdec.device_buffered(r, 2, device="cpu"),
                lambda r: tdec.xmap_readers(lambda x: x, r, 2, 2)):
        with pytest.raises(RuntimeError, match="reader failed"):
            list(dec(broken)())


def test_device_buffered_on_the_cpu_moves_every_array_leaf():
    lod = pt.LoD.from_lengths([[2, 3]])
    items = [{"words": LoDTensor(np.arange(5).reshape(5, 1), lod),
              "label": np.array([[1], [0]]), "tag": "batch-0"},
             (np.ones((2, 2), np.float32), 7)]
    got = list(tdec.device_buffered(_reader(items), size=1,
                                    device="cpu")())
    assert got[0]["tag"] == "batch-0" and got[1][1] == 7
    assert isinstance(got[0]["words"], LoDTensor)
    assert got[0]["words"].lod == lod
    assert torch.equal(got[0]["words"].array,
                       torch.arange(5).reshape(5, 1))
    assert torch.equal(got[0]["label"], torch.tensor([[1], [0]]))
    assert isinstance(got[1], tuple) and torch.equal(got[1][0],
                                                     torch.ones(2, 2))


def test_device_buffered_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.device_buffered(_reader([1]))


def test_creators(tmp_path):
    arr = np.arange(12).reshape(4, 3)
    _same(list(tcreator.np_array(arr)()), list(arr))
    path = tmp_path / "lines.txt"
    path.write_text("a b\nc\n\nd")
    assert list(tcreator.text_file(str(path))()) == ["a b", "c", "", "d"]
    with pytest.raises(NotImplementedError, match="A11"):
        tcreator.recordio([str(path)])
    with pytest.raises(NotImplementedError, match="A11"):
        tcreator.cloud_reader("*.rec", "localhost:0")


DATASETS = {
    "imdb_train": (lambda m: m.train(), jimdb, timdb),
    "imdb_test": (lambda m: m.test(), jimdb, timdb),
    "uci_housing_train": (lambda m: m.train(), juci, tuci),
    "uci_housing_test": (lambda m: m.test(), juci, tuci),
    "mnist_train": (lambda m: m.train(), jmnist, tmnist),
    "mnist_test": (lambda m: m.test(), jmnist, tmnist),
}
# the nine other datasets: name -> (reader over the module, its name)
for _name, _make in {
        "imikolov_train": lambda m: m.train(m.build_dict(min_word_freq=1),
                                            n=3),
        "imikolov_test": lambda m: m.test(n=5),
        "sentiment_train": lambda m: m.train(),
        "sentiment_test": lambda m: m.test(),
        "wmt14_train": lambda m: m.train(),
        "wmt14_test": lambda m: m.test(dict_size=100),
        "movielens_train": lambda m: m.train(),
        "movielens_test": lambda m: m.test(),
        "conll05_train": lambda m: m.train(),
        "conll05_test": lambda m: m.test(),
        "ctr_train": lambda m: m.train(),
        "ctr_test": lambda m: m.test(),
        "mq2007_pairwise": lambda m: m.train(),
        "mq2007_pointwise": lambda m: m.train(format="pointwise"),
        "mq2007_listwise": lambda m: m.test(format="listwise"),
        "flowers_train": lambda m: m.train(16),
        "flowers_valid": lambda m: m.valid(8),
        "voc2012_train": lambda m: m.train(),
        "voc2012_val": lambda m: m.val(),
}.items():
    _mod = _name.split("_")[0]
    DATASETS[_name] = (_make, getattr(jds, _mod), getattr(tds, _mod))

# module -> its other public functions, each equal between the packages
DATASET_TABLES = {
    "imikolov": lambda m: m.build_dict(min_word_freq=1),
    "sentiment": lambda m: m.get_word_dict(),
    "movielens": lambda m: (m.max_user_id(), m.max_movie_id(),
                            m.max_job_id(), m.num_categories(),
                            m.title_vocab_size()),
    "conll05": lambda m: (m.get_dict(), m.get_embedding() is None),
}


@pytest.mark.parametrize("source", ["fixtures", "surrogate"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_samples_match_jax(name, source, monkeypatch, tmp_path):
    home = FIXTURES if source == "fixtures" else str(tmp_path)
    monkeypatch.setattr(jcommon, "DATA_HOME", home)
    monkeypatch.setattr(tcommon, "DATA_HOME", home)
    make, jmod, tmod = DATASETS[name]
    for mod in (jmod, tmod):
        getattr(mod, "_META_CACHE", {}).clear()   # kept per DATA_HOME
    want = list(zip(range(64), make(jmod)()))
    got = list(zip(range(64), make(tmod)()))
    assert len(got) == len(want) > 0
    _same(got, want)
    if name.startswith("imdb"):
        assert timdb.word_dict() == jimdb.word_dict()
    table = DATASET_TABLES.get(name.split("_")[0])
    if table is not None:
        _same(table(tmod), table(jmod))
    for mod in (jmod, tmod):
        getattr(mod, "_META_CACHE", {}).clear()


def _provider_samples(seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(12):
        yield (rng.randn(3).tolist(), int(rng.randint(0, 5)),
               rng.choice(10, int(rng.randint(0, 4)), replace=False).tolist(),
               rng.randint(0, 7, int(rng.randint(1, 5))).tolist(),
               [rng.randn(2) for _ in range(int(rng.randint(1, 3)))])


def _provider_types(mod):
    return [mod.dense_vector(3), mod.integer_value(5),
            mod.sparse_binary_vector(10), mod.integer_value_sequence(7),
            mod.dense_vector_sequence(2)]


@pytest.mark.parametrize("mode", ["plain", "shuffled", "buffered"])
def test_provider_samples_match_jax(mode):
    """``reader.provider`` (also ``reader.data_provider``) converts each
    slot as the JAX one does; shuffled, the same samples in some order;
    a sample that breaks its declaration raises the same error."""
    kw = {"plain": {}, "shuffled": {"should_shuffle": True},
          "buffered": {"buffer_size": 4}}[mode]
    assert pt.reader.data_provider is tprovider.provider
    got = list(tprovider.provider(_provider_types(tprovider), **kw)(
        _provider_samples)(1)())
    want = list(jreader.data_provider(_provider_types(jprovider), **kw)(
        _provider_samples)(1)())
    assert len(got) == len(want) == 12
    if mode == "shuffled":
        key = lambda smp: repr([np.asarray(x).tolist()  # noqa: E731
                                for x in smp[:4]])
        got, want = sorted(got, key=key), sorted(want, key=key)
    _same(got, want)

    def bad():
        yield ([0.0, 1.0, 2.0], 9, [], [1], [np.zeros(2)])

    for mod in (tprovider, jprovider):
        with pytest.raises(ValueError, match="outside"):
            list(mod.provider(_provider_types(mod))(bad)()())


def _feed_vars(layers, mod):
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = ((pt.Program(), pt.Program()) if mod is tprog
                   else (mod.Program(), mod.Program()))
    guard = pt.program_guard if mod is tprog else mod.program_guard
    try:
        with guard(main, start):
            return [layers.data("x", [3]),
                    layers.data("y", [1], dtype="int64"),
                    layers.data("words", [1], dtype="int64", lod_level=1),
                    layers.data("para", [2], dtype="float32", lod_level=2)]
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


def test_data_feeder_matches_jax():
    rng = np.random.RandomState(4)
    batch = [(rng.randn(3).astype(np.float32), int(rng.randint(5)),
              rng.randint(0, 9, int(rng.randint(1, 5))).tolist(),
              [rng.randn(int(rng.randint(1, 4)), 2) for _ in
               range(int(rng.randint(1, 3)))])
             for _ in range(4)]
    want = jfeeder.DataFeeder(_feed_vars(jlayers, jprog)).feed(batch)
    got = tfeeder.DataFeeder(_feed_vars(pt.layers, tprog)).feed(batch)
    assert set(got) == set(want)
    for n in ("x", "y"):
        assert isinstance(got[n], np.ndarray)
        assert got[n].dtype == np.asarray(want[n]).dtype
        np.testing.assert_array_equal(got[n], np.asarray(want[n]))
    for n in ("words", "para"):
        assert isinstance(got[n], LoDTensor)
        np.testing.assert_array_equal(got[n].array.numpy(),
                                      np.asarray(want[n].array))
        assert got[n].array.dtype == (torch.int64 if n == "words"
                                      else torch.float32)
        assert [lv.tolist() for lv in got[n].lod.levels] == [
            np.asarray(lv).tolist() for lv in want[n].lod.levels]
