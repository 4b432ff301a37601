"""The port's ``Trainer`` (and ``io``) held against the JAX package's on
the CPU: port versions of ``tests/test_book.py``'s ``fit_a_line``,
``recognize_digits_mlp``, ``trainer_events_sequence``,
``understand_sentiment_conv``, ``understand_sentiment_stacked_lstm`` and
``word2vec``.

Each model is built through both packages in fresh programs (cleared
name counters, fresh global scopes) and wrapped in a ``Trainer`` on
``CPUPlace``; the JAX Trainer runs its startup program and its
persistables are carried into the port's scope with
``convert.scope_from_jax`` (a JAX PRNG stream is not a torch one), then
both train over the same reader. The event streams are equal type by
type, with the same pass and batch ids, and each EndIteration's cost and
metrics are allclose at atol/rtol 1e-5 (fp32: the same math, sums in
another order; a few passes of the book's small models). ``test()``
and the end-of-pass evaluator results agree the same way.

Port-internal, bit for bit: ``steps_per_call=4`` (``run_multi`` over
groups of one signature; a ragged reader's mixed groups and the tail
step by step) gives the costs and parameters of K = 1, and
``double_buffer=True`` those of ``False``. ``save_params`` ->
``load_params`` round-trips, a checkpoint written by the JAX
``io.save_params`` loads into the port and one written by the port loads
into the JAX package (values bit-equal, the manifest's sha256 checked),
a corrupted file raises ``CheckpointError``, ``save_dir`` with
``save_period=1`` writes each pass's parameters, and
``save_inference_model`` -> ``load_inference_model`` gives the pruned
program's predictions.
The options not ported yet raise naming their ROADMAP item, and with no
place the Trainer's Executor is the card (it raises without one). The
card's cases are in ``tests/test_torch_trainer_cuda.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import reader as jreader
from paddle_tpu import datasets as jdatasets
from paddle_tpu.core import scope as jscope
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import text as jtext
from paddle_tpu.trainer import Trainer as JTrainer

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch import datasets as tdatasets
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.trainer import MasterTrainer, Trainer

TOL = 1e-5
SIDES = {"jax": (jpt, jreader, jdatasets, jmnist, jtext, JTrainer, jprog,
                 jscope),
         "torch": (pt, treader, tdatasets, tmnist, ttext, Trainer, tprog,
                   tscope)}


@pytest.fixture(autouse=True)
def clean_state():
    for side in SIDES.values():
        side[6].fresh_programs()
        side[7].reset_global_scope()
    yield
    for side in SIDES.values():
        side[6].fresh_programs()
        side[7].reset_global_scope()


def _recorder(out):
    def handler(e):
        row = [type(e).__name__, getattr(e, "pass_id", None),
               getattr(e, "batch_id", None)]
        if hasattr(e, "cost"):
            row += [e.cost, dict(e.metrics)]
        if hasattr(e, "evaluator_results"):
            row += [dict(e.evaluator_results)]
        out.append(row)
    return handler


def _fit_a_line(side, lr=0.01):
    pkg = SIDES[side][0]
    x = pkg.layers.data("x", [13])
    y = pkg.layers.data("y", [1])
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(x, 1), y))
    return loss, pkg.optimizer.SGD(lr), [x, y], []


def _mlp(side):
    pkg, models = SIDES[side][0], SIDES[side][3]
    img = pkg.layers.data("img", [784])
    label = pkg.layers.data("label", [1], dtype="int64")
    _, loss, acc = models.mlp(img, label)
    return loss, pkg.optimizer.Adam(0.01), [img, label], [acc]


def _events_net(side):
    pkg = SIDES[side][0]
    x = pkg.layers.data("x", [4])
    y = pkg.layers.data("y", [1])
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(x, 1), y))
    return loss, pkg.optimizer.SGD(0.1), [x, y], []


def _sentiment(side, stacked):
    pkg, text = SIDES[side][0], SIDES[side][4]
    data = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pkg.layers.data("label", [1], dtype="int64")
    if stacked:
        _, loss, acc = text.stacked_lstm_net(data, label, input_dim=64,
                                             emb_dim=16, hid_dim=16,
                                             stacked_num=2)
    else:
        _, loss, acc = text.convolution_net(data, label, input_dim=64,
                                            emb_dim=16, hid_dim=16)
    return loss, pkg.optimizer.Adam(0.01), [data, label], [acc]


def _word2vec(side):
    pkg, text = SIDES[side][0], SIDES[side][4]
    words = [pkg.layers.data(f"w{i}", [1], dtype="int64") for i in range(4)]
    nxt = pkg.layers.data("next", [1], dtype="int64")
    _, loss = text.word2vec_net(words, nxt, dict_size=128, emb_dim=8,
                                hid_dim=32)
    return loss, pkg.optimizer.SGD(0.1), words + [nxt], []


def _trainer(side, build, place=True):
    trainer_cls = SIDES[side][5]
    pkg = SIDES[side][0]
    loss, opt, feed_list, metrics = build(side)
    kw = {"place": pkg.CPUPlace()} if place else {}
    return trainer_cls(cost=loss, optimizer=opt, feed_list=feed_list,
                       metrics=metrics, **kw), loss, metrics


def _pair(build):
    """The JAX Trainer after its startup program, and the port's from the
    same state."""
    jtr, jloss, _ = _trainer("jax", build)
    jtr._init_params()
    state = {n: np.array(jscope.global_scope().find_var(n).array)
             for n, v in jtr.main_program.global_block().vars.items()
             if v.persistable
             and jscope.global_scope().find_var(n) is not None}
    ttr, tloss, _ = _trainer("torch", build)
    scope_from_jax(state, device="cpu")
    ttr._initialized = True
    return jtr, ttr


def _same_events(got, want):
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for g, w in zip(got, want):
        for a, b in zip(g[3:], w[3:]):
            if isinstance(a, dict):
                assert set(a) == set(b)
                for k in a:
                    np.testing.assert_allclose(a[k], b[k], atol=TOL,
                                               rtol=TOL, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def _imdb_like_reader(n, vocab, seed=0, min_len=5, max_len=15):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(min_len, max_len))
            lo, hi = (0, vocab // 2) if label else (vocab // 2, vocab)
            words = rng.randint(lo, hi, length).astype(np.int64)
            yield words.tolist(), label

    return reader


def _word2vec_samples():
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(128):
        seq = [int(rng.randint(0, 128))]
        for _ in range(4):
            seq.append((3 * seq[-1] + int(rng.randint(0, 3))) % 128)
        samples.append(tuple(np.int64(x) for x in seq))
    return samples


def _events_data():
    rng = np.random.RandomState(0)
    return [(rng.randn(4).astype(np.float32), np.ones(1, np.float32))
            for _ in range(8)]


# name -> (builder, reader factory over one side's modules, passes)
BOOK = {
    "fit_a_line": (_fit_a_line, lambda r, d: r.batch(r.shuffle(
        d.uci_housing.train(256), 256, seed=0), 32), 2),
    "recognize_digits_mlp": (_mlp, lambda r, d: r.batch(
        d.mnist.train(256), 64), 2),
    "trainer_events_sequence": (_events_net, lambda r, d: r.batch(
        lambda: iter(_events_data()), 4), 2),
    "understand_sentiment_conv": (
        lambda s: _sentiment(s, False),
        lambda r, d: r.batch(_imdb_like_reader(48, 64), 16), 2),
    "understand_sentiment_stacked_lstm": (
        lambda s: _sentiment(s, True),
        lambda r, d: r.batch(_imdb_like_reader(48, 64, seed=1), 16), 2),
    "word2vec": (_word2vec, lambda r, d: r.batch(
        lambda: iter(_word2vec_samples()), 32), 2),
}


@pytest.mark.parametrize("name", list(BOOK))
def test_book_training_matches_jax(name):
    build, make_reader, passes = BOOK[name]
    jtr, ttr = _pair(build)
    want, got = [], []
    jtr.train(make_reader(jreader, jdatasets), num_passes=passes,
              event_handler=_recorder(want), log_period=0)
    ttr.train(make_reader(treader, tdatasets), num_passes=passes,
              event_handler=_recorder(got), log_period=0)
    _same_events(got, want)
    if name == "trainer_events_sequence":
        assert [r[0] for r in got] == [
            "BeginPass", "BeginIteration", "EndIteration",
            "BeginIteration", "EndIteration", "EndPass"] * 2
    costs = [r[3] for r in got if r[0] == "EndIteration"]
    assert all(np.isfinite(costs)) and costs[-1] < costs[0]


def test_mid_pass_tests_and_test_match_jax():
    """``test_period`` with a ``test_reader`` (each mid-pass test and the
    pass's evaluator results), then ``test()`` over the test split."""
    jtr, ttr = _pair(_mlp)
    want, got = [], []
    kw = dict(num_passes=1, log_period=0, test_period=2)
    jtr.train(jreader.batch(jdatasets.mnist.train(256), 64),
              event_handler=_recorder(want),
              test_reader=jreader.batch(jdatasets.mnist.test(64), 32), **kw)
    ttr.train(treader.batch(tdatasets.mnist.train(256), 64),
              event_handler=_recorder(got),
              test_reader=treader.batch(tdatasets.mnist.test(64), 32), **kw)
    _same_events(got, want)
    j = jtr.test(jreader.batch(jdatasets.mnist.test(96), 32))
    t = ttr.test(treader.batch(tdatasets.mnist.test(96), 32))
    assert set(t) == set(j) == {"cost", ttr.metrics[0].name}
    for k in t:
        np.testing.assert_allclose(t[k], j[k], atol=TOL, rtol=TOL)


def _train_port(build, make_reader, **kw):
    """A port Trainer from the startup program (seed 3) over a new
    reader of ``make_reader`` (the synthetic readers draw from one
    stream per creator): its EndIteration (cost, metrics) and its
    parameters after."""
    tprog.fresh_programs()
    tscope.reset_global_scope()
    tr, _, _ = _trainer("torch", build)
    tr.startup_program.random_seed = 3
    out = []
    tr.train(make_reader(), num_passes=2, log_period=0,
             event_handler=_recorder(out), **kw)
    params = {p.name: tscope.global_scope().find_var(p.name).array.clone()
              for p in tr.main_program.global_block().all_parameters()}
    return [r[3:] for r in out if r[0] == "EndIteration"], params


@pytest.mark.parametrize("which", ["mlp", "sentiment_ragged"])
def test_steps_per_call_equals_single_steps(which, monkeypatch):
    from paddle_tpu_torch.framework.executor import Executor
    if which == "mlp":   # 5 batches: one group of 4, a tail of 1
        build = _mlp
        reader = lambda: treader.batch(  # noqa: E731
            tdatasets.mnist.train(320), 64)
    else:                # ragged LoD: each group's signatures differ
        build = lambda s: _sentiment(s, False)  # noqa: E731
        reader = lambda: treader.batch(  # noqa: E731
            _imdb_like_reader(80, 64), 16)
    calls = []
    orig = Executor.run_multi
    monkeypatch.setattr(Executor, "run_multi",
                        lambda self, *a, **k: (calls.append(len(k["feeds"])),
                                               orig(self, *a, **k))[1])
    one, p1 = _train_port(build, reader)
    assert not calls
    four, p4 = _train_port(build, reader, steps_per_call=4)
    assert calls == ([4, 4] if which == "mlp" else [])
    assert four == one
    for n in p1:
        assert torch.equal(p4[n], p1[n]), n


def test_double_buffer_equals_off():
    reader = lambda: treader.batch(_imdb_like_reader(64, 64), 16)  # noqa
    build = lambda s: _sentiment(s, False)  # noqa: E731
    off, p_off = _train_port(build, reader)
    on, p_on = _train_port(build, reader, double_buffer=True)
    assert on == off
    for n in p_off:
        assert torch.equal(p_on[n], p_off[n]), n


def _params(main, scope):
    return {p.name: np.array(scope.find_var(p.name).array)
            for p in main.global_block().all_parameters()}


def test_checkpoints_round_trip_and_cross_load(tmp_path):
    jtr, ttr = _pair(_mlp)
    reader = lambda r, d: r.batch(d.mnist.train(128), 64)  # noqa: E731
    jtr.train(reader(jreader, jdatasets), log_period=0)
    ttr.train(reader(treader, tdatasets), log_period=0)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jio.save_params(jtr.exe, jdir, jtr.main_program)
    ttr.save_params(tdir)
    with open(os.path.join(tdir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 1
    assert set(manifest["vars"]) == {
        p.name for p in ttr.main_program.global_block().all_parameters()}
    j_saved = _params(jtr.main_program, jscope.global_scope())
    t_saved = {k: v.numpy() for k, v in
               ((n, tscope.global_scope().find_var(n).array)
                for n in j_saved)}
    # the port's own checkpoint round-trips into a fresh scope
    fresh = tscope.Scope()
    tio.load_params(ttr.exe, tdir, ttr.main_program, scope=fresh)
    for n, v in t_saved.items():
        np.testing.assert_array_equal(fresh.find_var(n).array.numpy(), v)
    # the JAX checkpoint into the port, the port's into the JAX package
    ttr.load_params(jdir)
    for n, v in j_saved.items():
        np.testing.assert_array_equal(
            tscope.global_scope().find_var(n).array.numpy(), v)
    jio.load_params(jtr.exe, tdir, jtr.main_program)
    for n, v in t_saved.items():
        np.testing.assert_array_equal(
            np.asarray(jscope.global_scope().find_var(n).array), v)
    # the integrity check
    victim = os.path.join(tdir, manifest["vars"]["fc_0.w_0"]["file"])
    with open(victim, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(tio.CheckpointError, match="integrity"):
        tio.load_params(ttr.exe, tdir, ttr.main_program, scope=fresh)
    with pytest.raises(tio.CheckpointError, match="MANIFEST"):
        tio.load_vars(ttr.exe, str(tmp_path), ["x"])


def test_save_period_writes_each_pass_checkpoint(tmp_path):
    """``save_dir`` + ``save_period=1``: after each pass the parameters
    are checkpointed; the last checkpoint holds the trained values."""
    tr, _, _ = _trainer("torch", _fit_a_line)
    tr.startup_program.random_seed = 2
    saved = []

    def handler(e):
        if isinstance(e, pt.event.EndPass):
            with open(os.path.join(tmp_path, "ckpt", "MANIFEST.json")) as f:
                saved.append(json.load(f)["vars"])

    tr.train(treader.batch(tdatasets.uci_housing.train(64), 16),
             num_passes=2, save_dir=str(tmp_path / "ckpt"), save_period=1,
             log_period=0, event_handler=handler)
    params = tr.main_program.global_block().all_parameters()
    assert len(saved) == 2 and set(saved[-1]) == {p.name for p in params}
    fresh = tscope.Scope()
    tio.load_params(tr.exe, str(tmp_path / "ckpt"), tr.main_program,
                    scope=fresh)
    for p in params:
        assert torch.equal(fresh.find_var(p.name).array,
                           tscope.global_scope().find_var(p.name).array)


def test_persistables_and_inference_model(tmp_path):
    tr, loss, metrics = _trainer("torch", _mlp)
    tr.startup_program.random_seed = 1
    batch = [(np.full(784, i / 9.0, np.float32), i % 10) for i in range(8)]
    tr.train_one_batch(batch)
    scope = tscope.global_scope()
    tio.save_persistables(tr.exe, str(tmp_path / "all"), tr.main_program)
    other = tscope.Scope()
    names = tio.load_persistables(tr.exe, str(tmp_path / "all"),
                                  scope=other)
    assert any(n.startswith("moment1") for n in names)
    for n in names:
        assert torch.equal(other.find_var(n).array,
                           scope.find_var(n).array.cpu()), n
    pred = tr.test_program.global_block().var("softmax_0.tmp_0")
    feed = tr.feeder.feed(batch)
    want = tr.exe.run(tr.test_program, feed=feed, fetch_list=[pred])[0]
    tio.save_inference_model(str(tmp_path / "infer"), ["img"], [pred],
                             tr.exe, tr.main_program)
    program, feeds, fetches = tio.load_inference_model(
        str(tmp_path / "infer"), tr.exe, scope=other)
    assert feeds == ["img"] and fetches == [pred.name]
    types = [op.type for op in program.global_block().ops]
    assert "backward" not in types and "adam" not in types
    got = tr.exe.run(program, feed={"img": feed["img"]},
                     fetch_list=fetches, scope=other)[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,item", [
    ({"health": "warn"}, "A5"), ({"numerics": True}, "A5")])
def test_deferred_trainer_options_raise(kw, item):
    loss, opt, feed_list, _ = _fit_a_line("torch")
    with pytest.raises(NotImplementedError, match=item):
        Trainer(cost=loss, optimizer=opt, feed_list=feed_list,
                place=pt.CPUPlace(), **kw)


@pytest.mark.parametrize("kw,item", [
    ({"telemetry": True}, "A5"), ({"serve_port": 0}, "A5"),
    ({"profile_steps": (0, 2)}, "A10")])
def test_deferred_train_options_raise(kw, item):
    tr, _, _ = _trainer("torch", _fit_a_line)
    with pytest.raises(NotImplementedError, match=item):
        tr.train(treader.batch(tdatasets.uci_housing.train(8), 4), **kw)


def test_master_trainer_and_default_place():
    with pytest.raises(NotImplementedError, match="A11"):
        MasterTrainer(None, None, [], master_addr="localhost:0",
                      glob_paths=[], deserialize=None)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer("torch", _fit_a_line, place=False)
