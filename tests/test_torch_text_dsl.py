"""The port's text ops, layers DSL, nets and book models held against
the JAX package's on the CPU.

The ops (each against the JAX registry's compute on the same
numpy-seeded inputs; outputs, then the gradients of sum(sin(out)) for
every float input):

- ``concat``, ``square_error_cost``, ``sigmoid``, ``tanh`` and
  ``sequence_conv`` (ragged LoD, context 3 and 4): fp32 outputs at
  atol/rtol 1e-5, gradients at 1e-5;
- ``dynamic_gru`` at D 128 / B 8 (``_fused_ok`` holds: the route whose
  kernels are B12 / B13, here their plain versions; the JAX side's
  Pallas kernels forced in interpret mode with ``FORCE_FOR_TESTS``) and
  at D 24 (the step-by-step route on both sides): uniform, ragged with
  a length-1 sequence, ``is_reverse``, ``SeqLens`` and ``H0``; fp32
  Hidden and every gradient at 1e-5; bf16 (the AMP lane) at
  ``tests/test_torch_lstm.py``'s BF16_FWD_TOL 2e-2.

The DSL: each text net (``lstm_benchmark_net`` fused and composed, with
and without ``seq_lens``, ``stacked_lstm_net``, ``convolution_net``,
``word2vec_net``, a ``dynamic_gru`` net, ``nets.glu`` and
``nets.scaled_dot_product_attention``) and each book model built by both
packages from cleared name counters, with an optimizer, gives the same
main and startup op lists (types, slots -> names, attributes), the same
variables (shape, dtype, LoD level, persistable) and the same
``fingerprint``. ``text.build_program`` equals the DSL-built
``lstm_benchmark_net`` the same way, and from one startup state the two
programs' CPU losses over 3 Adam steps are bit-equal (the same ops in
the same order).

Training: from the JAX startup program's state carried over with
``convert.scope_from_jax``, 3 ``Adam(0.002)`` steps (bench.py's) through
both Executors give losses and persistables at atol/rtol 1e-5 (fp32:
the same math, sums in another order), Adam's eps-regime elements at
1e-4 (``tests/test_torch_executor.py``'s note: an element whose first
nonzero gradient is under 1e-6 takes an update that two fp32 summation
orders move by up to lr * 2e-9 / 3.2e-7).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.lod import LoD as JLoD
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.framework import program as jprog
from paddle_tpu.framework import registry as jreg
from paddle_tpu.kernels import fused_rnn as jfr
from paddle_tpu.models import book as jbook
from paddle_tpu.models import text as jtext
from paddle_tpu import nets as jnets

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core.lod import LoD, LoDTensor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.kernels import fused_rnn as tfr
from paddle_tpu_torch.models import book as tbook
from paddle_tpu_torch.models import text as tx
from paddle_tpu_torch import nets as tnets

TOL = 1e-5
BF16_FWD_TOL = 2e-2
ADAM_EPS_REGIME = 1e-6
ADAM_EPS_REGIME_TOL = 1e-4
LR = 0.002                 # bench.py's Adam(0.002)
RAGGED = [1, 7, 3, 5, 7, 2, 6, 4]          # a length-1 sequence included
UNIFORM = [7] * 8


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=what)


# ------------------------------------------------------------- the ops

def _run_jax(op, ins, attrs, lods, grad_of, out_slot):
    """The JAX op's ``out_slot`` and the gradients of sum(sin(out)) in
    the slots of ``grad_of`` (each a list of arrays), as numpy."""
    import jax
    import jax.numpy as jnp
    info = jreg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    jl = {s: [JLoD.from_lengths([list(x)]) if x is not None else None
              for x in v] for s, v in lods.items()}

    def run(diff):
        args = {s: [diff[s][i] if s in diff else jnp.asarray(a)
                    for i, a in enumerate(v)] for s, v in ins.items()}
        ctx = jreg.OpContext(attrs=full, in_lods=jl)
        return info.compute(args, full, ctx)[out_slot]

    base = {s: [jnp.asarray(a) for a in ins[s]] for s in grad_of}
    out = run(base)
    grads = {}
    if grad_of:
        g = jax.grad(lambda d: jnp.sum(jnp.sin(
            run(d).astype(jnp.float32))))(base)
        grads = {s: [np.asarray(x, np.float32) for x in g[s]]
                 for s in grad_of}
    return np.asarray(out, np.float32), grads


def _run_port(op, ins, attrs, lods, grad_of, out_slot, dtype=None):
    info = treg.get_op_info(op)
    full = dict(info.attrs, **attrs)
    live = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in ins.items()}
    if dtype is not None:
        live = {s: [t.to(dtype) if t.is_floating_point() else t
                    for t in v] for s, v in live.items()}
    for s in grad_of:
        for t in live[s]:
            t.requires_grad_(True)
    tl = {s: [LoD.from_lengths([list(x)]) if x is not None else None
              for x in v] for s, v in lods.items()}
    ctx = treg.OpContext(attrs=full, in_lods=tl)
    out = info.compute(live, full, ctx)[out_slot]
    grads = {}
    if grad_of:
        flat = [t for s in grad_of for t in live[s]]
        g = torch.autograd.grad(torch.sum(torch.sin(out.float())), flat)
        it = iter(g)
        grads = {s: [next(it) for _ in live[s]] for s in grad_of}
    return out, grads, ctx


def _rand(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _simple_cases():
    rng = np.random.RandomState(0)
    x3 = [_rand(rng, 6, 3), _rand(rng, 6, 5), _rand(rng, 6, 2)]
    seq = _rand(rng, sum(RAGGED), 6)
    return {
        "concat_axis1": ("concat", {"X": x3}, {"axis": 1}, {}, ("X",)),
        "concat_axis0": ("concat", {"X": [_rand(rng, 2, 4),
                                          _rand(rng, 3, 4)]},
                         {"axis": 0}, {}, ("X",)),
        "square_error_cost": ("square_error_cost",
                              {"X": [_rand(rng, 8, 1)],
                               "Y": [_rand(rng, 8, 1)]}, {}, {},
                              ("X", "Y")),
        "sigmoid": ("sigmoid", {"X": [_rand(rng, 5, 7, scale=3.0)]}, {}, {},
                    ("X",)),
        "tanh": ("tanh", {"X": [_rand(rng, 5, 7, scale=3.0)]}, {}, {},
                 ("X",)),
        "sequence_conv_3": ("sequence_conv",
                            {"X": [seq], "Filter": [_rand(rng, 18, 4)]},
                            {"contextLength": 3}, {"X": [RAGGED]},
                            ("X", "Filter")),
        "sequence_conv_4": ("sequence_conv",
                            {"X": [seq], "Filter": [_rand(rng, 24, 4)]},
                            {"contextLength": 4}, {"X": [RAGGED]},
                            ("X", "Filter")),
    }


SIMPLE = _simple_cases()


@pytest.mark.parametrize("name", list(SIMPLE))
def test_new_op_matches_jax(name):
    op, ins, attrs, lods, grad_of = SIMPLE[name]
    want, j_g = _run_jax(op, ins, attrs, lods, grad_of, "Out")
    got, g, _ = _run_port(op, ins, attrs, lods, grad_of, "Out")
    assert tuple(got.shape) == want.shape
    _close(got, want, TOL, what=f"{name} Out")
    for s in grad_of:
        for a, b in zip(g[s], j_g[s]):
            _close(a, b, TOL, what=f"{name} d{s}")


def test_sequence_conv_bf16_matches_jax():
    import jax.numpy as jnp
    op, ins, attrs, lods, _ = SIMPLE["sequence_conv_3"]
    j_ins = {s: [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in v]
             for s, v in ins.items()}
    want, _ = _run_jax(op, j_ins, attrs, lods, (), "Out")
    f32 = {s: [a.astype(np.float32) for a in v] for s, v in j_ins.items()}
    got, _, _ = _run_port(op, f32, attrs, lods, (), "Out",
                          dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_FWD_TOL, what="bf16 Out")


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """The JAX ops' fused route on the CPU (Pallas interpret), as
    tests/test_fused_rnn.py forces it."""
    monkeypatch.setattr(jfr, "FORCE_FOR_TESTS", True)


def _gru_case(seed, lens, D):
    rng = np.random.RandomState(seed)
    return {"Input": [_rand(rng, sum(lens), 3 * D)],
            "Weight": [_rand(rng, D, 3 * D, scale=0.1)],
            "Bias": [_rand(rng, 1, 3 * D, scale=0.1)],
            "H0": [_rand(rng, len(lens), D, scale=0.3)]}


# (lens, is_reverse, SeqLens, H0)
GRU_CASES = {
    "uniform": (UNIFORM, False, None, False),
    "ragged-reverse-h0": (RAGGED, True, None, True),
    "seqlens": (UNIFORM, False, [7, 1, 3, 5, 7, 2, 6, 4], False),
    "ragged-seqlens-reverse": (RAGGED, True, [1, 5, 3, 5, 7, 1, 6, 4],
                               True),
}


@pytest.mark.parametrize("D", [128, 24], ids=["kernel-route", "step-route"])
@pytest.mark.parametrize("name", list(GRU_CASES))
def test_dynamic_gru_matches_jax(jax_kernel_route, monkeypatch, name, D):
    lens, rev, seq_lens, h0 = GRU_CASES[name]
    ins = _gru_case(3, lens, D)
    if not h0:
        del ins["H0"]
    if seq_lens is not None:
        ins["SeqLens"] = [np.asarray(seq_lens, np.int32)]
    grad_of = tuple(s for s in ins if s != "SeqLens")
    attrs = {"is_reverse": rev}
    lods = {"Input": [lens]}
    want, j_g = _run_jax("dynamic_gru", ins, attrs, lods, grad_of, "Hidden")
    calls = []
    orig = tfr._GruScan.apply
    monkeypatch.setattr(tfr._GruScan, "apply",
                        lambda *a: (calls.append(1), orig(*a))[1])
    before = dict(tk.LAUNCHES)
    got, g, ctx = _run_port("dynamic_gru", ins, attrs, lods, grad_of,
                            "Hidden")
    assert calls == ([1] if D == 128 else [])   # the JAX op's route
    assert tk.LAUNCHES == before                 # CPU: the plain versions
    assert ctx.out_lods["Hidden"][0] == LoD.from_lengths([lens])
    _close(got, want, TOL, what="Hidden")
    for s in grad_of:
        _close(g[s][0], j_g[s][0], TOL, what=f"d{s}")


def test_dynamic_gru_flag_off_takes_the_step_route(monkeypatch):
    from paddle_tpu.flags import FLAGS as JFLAGS
    monkeypatch.setattr(FLAGS, "fused_rnn", False)
    monkeypatch.setattr(JFLAGS, "fused_rnn", False)
    ins = _gru_case(5, RAGGED, 128)
    attrs, lods = {"is_reverse": True}, {"Input": [RAGGED]}
    want, j_g = _run_jax("dynamic_gru", ins, attrs, lods, ("Input",),
                         "Hidden")
    calls = []
    orig = tfr._GruScan.apply
    monkeypatch.setattr(tfr._GruScan, "apply",
                        lambda *a: (calls.append(1), orig(*a))[1])
    got, g, _ = _run_port("dynamic_gru", ins, attrs, lods, ("Input",),
                          "Hidden")
    assert not calls
    _close(got, want, TOL, what="Hidden")
    _close(g["Input"][0], j_g["Input"][0], TOL, what="dInput")


def test_dynamic_gru_bf16_matches_jax(jax_kernel_route):
    import jax.numpy as jnp
    ins = _gru_case(9, RAGGED, 128)
    j_ins = {s: [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in v]
             for s, v in ins.items()}
    lods = {"Input": [RAGGED]}
    want, _ = _run_jax("dynamic_gru", j_ins, {}, lods, (), "Hidden")
    f32 = {s: [a.astype(np.float32) for a in v] for s, v in j_ins.items()}
    got, _, _ = _run_port("dynamic_gru", f32, {}, lods, (), "Hidden",
                          dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_FWD_TOL, what="bf16 Hidden")


def test_op_registrations_match_jax():
    for op in ("concat", "square_error_cost", "sequence_conv", "sigmoid",
               "tanh", "dynamic_gru", "split", "scale", "matmul",
               "elementwise_sub", "elementwise_mul", "elementwise_div"):
        j, t = jreg.get_op_info(op), treg.get_op_info(op)
        assert (tuple(t.inputs), tuple(t.outputs), t.attrs,
                tuple(t.optional_inputs), t.amp_compute) == (
            tuple(j.inputs), tuple(j.outputs), j.attrs,
            tuple(j.optional_inputs), j.amp_compute), op


# ------------------------------------------------------------ the DSL

@contextlib.contextmanager
def fresh(side):
    """New main and startup programs of one package under
    ``program_guard``, its name counters cleared for the build and
    restored after."""
    mod, pkg = (jprog, jpt) if side == "jax" else (tprog, pt)
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = pkg.Program(), pkg.Program()
    try:
        with pkg.program_guard(main, start):
            yield main, start
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


def _words(pkg):
    return (pkg.layers.data("words", [1], dtype="int64", lod_level=1),
            pkg.layers.data("label", [1], dtype="int64"))


def _gru_net(pkg, text, nets):
    words, label = _words(pkg)
    emb = pkg.layers.embedding(words, size=[40, 16])
    proj = pkg.layers.fc(emb, 3 * 24)
    hidden = pkg.layers.dynamic_gru(proj, 24, is_reverse=True)
    last = pkg.layers.sequence_pool(hidden, "last")
    logits = pkg.layers.fc(last, 2, act="tanh")
    return pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits,
                                                                 label))


def _glu_attention_net(pkg, text, nets):
    x = pkg.layers.data("x", [6, 8], append_batch_size=False)
    y = pkg.layers.data("y", [6, 4], append_batch_size=False)
    g = nets.glu(pkg.layers.fc(x, 16), dim=-1)              # [6, 8]
    q = pkg.layers.concat([g, x], axis=1)                    # [6, 16]
    att = nets.scaled_dot_product_attention(q, q, q)
    h = pkg.layers.fc(pkg.layers.elementwise_sub(att, q), 4, act="sigmoid")
    return pkg.layers.mean(pkg.layers.square_error_cost(h * 2.0 + 1.0, y))


NETS = {
    "lstm_fused": lambda pkg, text, nets: text.lstm_benchmark_net(
        *_words(pkg), input_dim=40, emb_dim=128, hid_dim=128,
        fused_proj=True)[1],
    "lstm_composed": lambda pkg, text, nets: text.lstm_benchmark_net(
        *_words(pkg), input_dim=40, emb_dim=128, hid_dim=128)[1],
    "lstm_seq_lens": lambda pkg, text, nets: text.lstm_benchmark_net(
        *_words(pkg), input_dim=40, emb_dim=128, hid_dim=128,
        seq_lens=pkg.layers.data("seq_lens", [], dtype="int32"),
        fused_proj=True)[1],
    "stacked_lstm": lambda pkg, text, nets: text.stacked_lstm_net(
        *_words(pkg), input_dim=40, emb_dim=16, hid_dim=16,
        stacked_num=3)[1],
    "convolution": lambda pkg, text, nets: text.convolution_net(
        *_words(pkg), input_dim=40, emb_dim=16, hid_dim=16)[1],
    "word2vec_net": lambda pkg, text, nets: text.word2vec_net(
        [pkg.layers.data(f"w{i}", [1], dtype="int64") for i in range(4)],
        pkg.layers.data("next", [1], dtype="int64"), dict_size=64,
        emb_dim=8, hid_dim=32)[1],
    "gru": _gru_net,
    "glu_attention": _glu_attention_net,
}


def _build(side, name, opt=True):
    pkg, text, nets = ((jpt, jtext, jnets) if side == "jax"
                       else (pt, tx, tnets))
    with fresh(side) as (main, start):
        loss = NETS[name](pkg, text, nets)
        if opt:
            pkg.optimizer.Adam(LR).minimize(loss)
    return main, start, loss


def _dtype(dt):
    return (tdtype.dtype_name(dt) if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _describe(program):
    block = program.global_block()
    ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in block.ops]
    var_sigs = {n: (v.shape, _dtype(v.dtype), v.lod_level, v.persistable)
                for n, v in block.vars.items()}
    params = [p.name for p in block.all_parameters()]
    return ops, var_sigs, params


def _same_programs(t_pair, j_pair):
    for t, j in zip(t_pair, j_pair):
        t_ops, t_vars, t_params = _describe(t)
        j_ops, j_vars, j_params = _describe(j)
        assert [o[0] for o in t_ops] == [o[0] for o in j_ops]
        for a, b in zip(t_ops, j_ops):
            assert a == b, (a, b)
        assert t_vars == j_vars
        assert t_params == j_params
        assert t.fingerprint() == j.fingerprint()


@pytest.mark.parametrize("name", list(NETS))
def test_text_net_programs_match_jax(name):
    jm, js, jl = _build("jax", name)
    tm, ts, tl = _build("torch", name)
    assert tl.name == jl.name
    _same_programs((tm, ts), (jm, js))


BOOK = ["fit_a_line", "recognize_digits_mlp", "word2vec",
        "understand_sentiment_conv"]


@pytest.mark.parametrize("name", BOOK)
def test_book_model_programs_match_jax(name):
    jl, jm, js = jbook.build_book_model(name)
    tl, tm, ts = tbook.build_book_model(name)
    assert tl.name == jl.name
    _same_programs((tm, ts), (jm, js))


@pytest.mark.parametrize("name", ["recognize_digits_conv", "smallnet_cifar"])
def test_conv_book_models_raise_naming_a8(name):
    """The conv book builders, the conv nets and attention with dropout
    raised naming A8 until the image path was ported; now they build
    (their programs equal the JAX package's in
    ``tests/test_torch_image.py``) and nothing of them names A8."""
    loss, main, _ = tbook.build_book_model(name)
    types = [op.type for op in main.global_block().ops]
    assert "conv2d" in types and "pool2d" in types and loss.shape == ()
    with fresh("torch") as (main, _):
        x = pt.layers.data("img", [1, 28, 28])
        a = tnets.simple_img_conv_pool(x, 4, 3, 2, 2)
        b = tnets.img_conv_group(x, [4], conv_with_batchnorm=True,
                                 conv_batchnorm_drop_rate=0.1)
        q = pt.layers.data("q", [6, 8])
        tnets.scaled_dot_product_attention(q, q, q, dropout_rate=0.1)
    assert a.shape == (-1, 4, 13, 13) and b.shape == (-1, 4, 14, 14)
    assert [op.type for op in main.global_block().ops].count("dropout") == 2
    with pytest.raises(KeyError, match="unknown book model"):
        tbook.build_book_model("no_such_model")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("seq_lens", [False, True], ids=["lod", "seq_lens"])
def test_dsl_lstm_benchmark_net_is_build_program(fused, seq_lens):
    """The DSL-built net at bench.py's widths is ``text.build_program``'s
    Program, main and startup, op for op and name for name."""
    cfg = tx.TextConfig(fused_proj=fused)
    with fresh("torch") as (main, start):
        words, label = _words(pt)
        sl = pt.layers.data("seq_lens", [], dtype="int32") if seq_lens \
            else None
        _, loss, acc = tx.lstm_benchmark_net(
            words, label, input_dim=cfg.vocab_size, emb_dim=cfg.emb_dim,
            hid_dim=cfg.hid_dim, num_layers=cfg.num_layers, seq_lens=sl,
            fused_proj=fused)
        pt.optimizer.Adam(0.002).minimize(loss)
    assert (loss.name, acc.name) == (tx.LOSS, tx.ACCURACY)
    with fresh("torch"):
        b_main, b_start = tx.build_program(cfg, seq_lens=seq_lens)
    _same_programs((main, start), (b_main, b_start))


@pytest.mark.parametrize("lens", [[5] * 8, [1, 5, 3, 4, 2, 5, 5, 1]],
                         ids=["uniform", "ragged"])
def test_dsl_lstm_benchmark_net_losses_bit_equal_build_program(lens):
    cfg = tx.TextConfig(vocab_size=40, emb_dim=128, hid_dim=128, amp=False)
    with fresh("torch") as (main, start):
        _, loss, _ = tx.lstm_benchmark_net(*_words(pt), input_dim=40,
                                           emb_dim=128, hid_dim=128,
                                           fused_proj=True)
        pt.optimizer.Adam(0.002).minimize(loss)
    with fresh("torch"):
        b_main, b_start = tx.build_program(cfg)
    rng = np.random.RandomState(3)
    feeds = [{"words": LoDTensor(torch.from_numpy(
        rng.randint(0, 40, (sum(lens), 1))), LoD.from_lengths([lens])),
        "label": torch.from_numpy(rng.randint(0, 2, (8, 1)))}
        for _ in range(3)]
    runs = []
    for m, s in ((main, start), (b_main, b_start)):
        scope, exe = Scope(), pt.Executor(pt.CPUPlace())
        s.random_seed = 7
        exe.run(s, scope=scope)
        runs.append([exe.run(m, feed=f, fetch_list=[tx.LOSS, tx.ACCURACY],
                             scope=scope) for f in feeds])
    for a, b in zip(*runs):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ------------------------------------------------- training vs the JAX side

def _persistables(main, scope, value):
    return {n: value(scope.find_var(n)) for n, v in
            main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _lod_feed(rng, lens, vocab, B=None):
    B = B or len(lens)
    words = rng.randint(0, vocab, (sum(lens), 1)).astype(np.int64)
    label = rng.randint(0, 2, (B, 1)).astype(np.int64)
    return {"words": (words, lens), "label": label}


def _feeds(name, n=3):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        if name.startswith("lstm"):
            f = _lod_feed(rng, [5] * 8 if name != "lstm_composed"
                          else RAGGED, 40)
            if name == "lstm_seq_lens":
                f["seq_lens"] = np.asarray([5, 1, 3, 4, 2, 5, 5, 1],
                                           np.int32)
        elif name in ("stacked_lstm", "convolution", "gru"):
            f = _lod_feed(rng, RAGGED, 40)
        elif name == "word2vec_net":
            f = {f"w{i}": rng.randint(0, 64, (8, 1)).astype(np.int64)
                 for i in range(4)}
            f["next"] = rng.randint(0, 64, (8, 1)).astype(np.int64)
        else:   # glu_attention
            f = {"x": rng.randn(6, 8).astype(np.float32),
                 "y": rng.randn(6, 4).astype(np.float32)}
        out.append(f)
    return out


def _as(f, lod_cls, tensor_cls):
    return {k: (tensor_cls(v[0], lod_cls.from_lengths([v[1]]))
                if isinstance(v, tuple) else v) for k, v in f.items()}


@pytest.mark.parametrize("name", list(NETS))
def test_text_net_adam_steps_match_jax(name):
    """From the JAX startup's state, 3 Adam steps on both sides: every
    loss, and every persistable after, at 1e-5."""
    from paddle_tpu.core.lod import LoDTensor as JLoDTensor
    jm, js, jl = _build("jax", name)
    tm, ts, tl = _build("torch", name)
    grads = [p.name + "@GRAD" for p in jm.global_block().all_parameters()]
    jscope, jexe = JScope(), jpt.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    init = _persistables(jm, jscope, lambda v: np.array(v.array))
    tscope = scope_from_jax(init, scope=Scope(), device="cpu")
    texe = pt.Executor(pt.CPUPlace())
    opening = {}
    for f in _feeds(name):
        got = jexe.run(jm, feed=_as(f, JLoD, JLoDTensor),
                       fetch_list=[jl] + grads, scope=jscope)
        for g, v in zip(grads, got[1:]):
            seen = opening.get(g)
            opening[g] = (np.asarray(v) if seen is None
                          else np.where(seen != 0, seen, np.asarray(v)))
        (loss,) = texe.run(tm, feed=_as(f, LoD, LoDTensor), fetch_list=[tl],
                           scope=tscope)
        _close(loss, got[0], TOL, what="loss")
    after = _persistables(jm, jscope, lambda v: np.array(v.array))
    for n, want in after.items():
        have = tscope.find_var(n).array.numpy()
        g = np.abs(opening.get(n + "@GRAD", np.zeros(1)))
        tiny = np.broadcast_to((g > 0) & (g < ADAM_EPS_REGIME), have.shape)
        err = np.abs(have - want)
        assert (err[tiny] <= ADAM_EPS_REGIME_TOL).all(), n
        bad = (err > TOL * (1 + np.abs(want))) & ~tiny
        assert not bad.any(), (n, float(err[~tiny].max(initial=0.0)))
