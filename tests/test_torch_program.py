"""The port's framework core held against the JAX package's on the CPU:
the Program IR and the layers DSL (``framework.program``,
``layers``, ``layer_helper``, ``initializer``, ``optimizer``), and the
core modules copied over (``core.dtype``, ``core.place``,
``core.scope``, ``core.selected_rows``, ``framework.dtype_limits``).

- The MNIST MLP (``models.mnist.mlp``, bench.py's widths 784-128-64-10)
  with ``Adam(0.01).minimize`` and with ``SGD(0.1).minimize`` built
  through both packages in fresh programs gives the same main and
  startup programs: every op's type, slot -> variable names and attrs,
  every variable's shape, dtype (by name), LoD level and persistable
  flag, the same parameters, and the same ``fingerprint``.
- ``clone(for_test=True)``: a copy that shares no op or variable object
  with its source.
- The copied modules: ``convert_dtype`` at every name, ``SelectedRows``
  ``to_dense`` / ``merge`` on duplicate and padding rows (exact: sums of
  at most three fp32 values in the same order), the dtype envelopes.
- The training plane's programs: ``regularization=`` ignored and
  ``global_clip_norm=`` (the clip's ops), the six other optimizers and
  ``ModelAverage``, a ``ParamAttr`` regularizer's decay ops, each equal
  to JAX's; a learning rate that is neither a number nor a schedule
  raising in both packages.
- What is not ported raises, naming its ROADMAP item.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import dtype as jdtype
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.framework import dtype_limits as jdl
from paddle_tpu.framework import program as jprog
from paddle_tpu.models import mnist as jmnist

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace, default_place
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.core.selected_rows import SelectedRows
from paddle_tpu_torch.framework import dtype_limits as tdl
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.models import mnist as tmnist

OPTS = {"adam": lambda m: m.optimizer.Adam(0.01),
        "sgd": lambda m: m.optimizer.SGD(0.1)}


@contextlib.contextmanager
def fresh(mod):
    """New main and startup programs of ``mod``'s package under
    ``program_guard``, its name counters cleared for the build (the
    names a fresh process gives) and restored after."""
    saved = dict(mod._name_counters)
    mod._name_counters.clear()
    main, start = mod.Program(), mod.Program()
    guard = (jpt if mod is jprog else pt).program_guard
    try:
        with guard(main, start):
            yield main, start
    finally:
        mod._name_counters.clear()
        mod._name_counters.update(saved)


def build_mlp(side, opt, batch_dims=(784,)):
    """bench.py's MLP through one package: (main, startup, loss)."""
    pkg, mod, models = ((jpt, jprog, jmnist) if side == "jax"
                        else (pt, tprog, tmnist))
    with fresh(mod) as (main, start):
        img = pkg.layers.data("img", list(batch_dims))
        label = pkg.layers.data("label", [1], dtype="int64")
        _, loss, _ = models.mlp(img, label)
        if opt is not None:
            OPTS[opt](pkg).minimize(loss)
    return main, start, loss


def _dtype(dt):
    return (tdtype.dtype_name(dt) if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _var_sig(v):
    return (v.shape, _dtype(v.dtype), v.lod_level, v.persistable,
            v.is_data, v.stop_gradient)


def _describe(program):
    block = program.global_block()
    ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in block.ops]
    var_sigs = {n: _var_sig(v) for n, v in block.vars.items()}
    params = [(p.name, p.trainable) for p in block.all_parameters()]
    return ops, var_sigs, params


@pytest.mark.parametrize("which", ["main", "startup"])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_mlp_programs_match_jax(opt, which):
    jmain, jstart, jloss = build_mlp("jax", opt)
    tmain, tstart, tloss = build_mlp("torch", opt)
    assert tloss.name == jloss.name
    jp, tp = (jmain, tmain) if which == "main" else (jstart, tstart)
    jops, jvars, jparams = _describe(jp)
    tops, tvars, tparams = _describe(tp)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for t_op, j_op in zip(tops, jops):
        assert t_op == j_op, (t_op[0], t_op, j_op)
    assert tvars == jvars
    assert tparams == jparams
    assert tp.fingerprint() == jp.fingerprint()


def test_mlp_forward_program_matches_jax_without_an_optimizer():
    jmain, jstart, _ = build_mlp("jax", None, (32,))
    tmain, tstart, _ = build_mlp("torch", None, (32,))
    assert _describe(tmain) == _describe(jmain)
    assert _describe(tstart) == _describe(jstart)
    types = [op.type for op in tmain.global_block().ops]
    assert types == ["mul", "elementwise_add", "relu", "mul",
                     "elementwise_add", "relu", "mul", "elementwise_add",
                     "softmax", "softmax_with_cross_entropy", "mean",
                     "top_k", "accuracy"]


def test_fc_over_two_inputs_sums_like_jax():
    progs = {}
    for side, pkg, mod in (("jax", jpt, jprog), ("torch", pt, tprog)):
        with fresh(mod) as (main, start):
            a = pkg.layers.data("a", [6])
            b = pkg.layers.data("b", [3])
            pkg.layers.fc([a, b], 4, act="softmax")
        progs[side] = (main, start)
    for j, t in zip(progs["jax"], progs["torch"]):
        assert _describe(t) == _describe(j)
    assert [op.type for op in progs["torch"][0].global_block().ops] == [
        "mul", "mul", "sum", "elementwise_add", "softmax"]


def test_clone_for_test_shares_nothing():
    main, _, _ = build_mlp("torch", "adam", (32,))
    test = main.clone(for_test=True)
    assert test.for_test and not main.for_test
    assert test.fingerprint() == main.fingerprint()
    for a, b in zip(main.global_block().ops, test.global_block().ops):
        assert (a.type, a.inputs, a.outputs, a.attrs) == (
            b.type, b.inputs, b.outputs, b.attrs)
        assert a is not b and a.attrs is not b.attrs
        assert a.inputs is not b.inputs and b.block is test.global_block()
    v = test.global_block().var("fc_0.w_0")
    assert v is not main.global_block().var("fc_0.w_0")
    v.optimize_attr["learning_rate"] = 0.5
    assert main.global_block().var("fc_0.w_0").optimize_attr == {
        "learning_rate": 1.0}


def test_variable_sugar_adds_and_names_what_is_missing():
    with fresh(tprog) as (main, _):
        a = pt.layers.data("a", [4])
        b = pt.layers.data("b", [4])
        c = a + b
        assert main.global_block().ops[-1].type == "elementwise_add"
        assert main.global_block().ops[-1].outputs == {"Out": [c.name]}
        d = a - b
        assert main.global_block().ops[-1].type == "elementwise_sub"
        assert main.global_block().ops[-1].outputs == {"Out": [d.name]}
        e = a * 2.0
        assert main.global_block().ops[-1].type == "scale"
        assert main.global_block().ops[-1].attrs == {
            "scale": 2.0, "bias": 0.0, "bias_after_scale": True}
        assert e.shape == a.shape
        # scalar / Variable: reciprocal, then scale by the scalar, as the
        # JAX DSL appends them
        f = 2.0 / a
        ops = main.global_block().ops
        assert [o.type for o in ops[-2:]] == ["reciprocal", "scale"]
        assert ops[-2].inputs == {"X": [a.name]}
        assert ops[-1].attrs == {"scale": 2.0, "bias": 0.0,
                                 "bias_after_scale": True}
        assert ops[-1].outputs == {"Out": [f.name]}


def test_block_var_lookup_names_near_misses():
    main, _, _ = build_mlp("torch", None, (32,))
    with pytest.raises(KeyError, match="fc_0.w_0"):
        main.global_block().var("fc_0.w0")
    with pytest.raises(KeyError, match="unknown op type"):
        main.global_block().append_op("no_such_op")


@pytest.mark.parametrize("name", sorted(tdtype._DTYPE_MAP))
def test_convert_dtype_matches_jax(name):
    jname = np.dtype(jdtype.convert_dtype(name)).name
    assert tdtype.dtype_name(name) == jname
    assert tdtype.is_float(name) == bool(jdtype.is_float(name))
    assert tdtype.is_integer(name) == bool(jdtype.is_integer(name))


def test_convert_dtype_defaults_and_refusals():
    assert tdtype.convert_dtype(None) == torch.float32
    assert tdtype.convert_dtype(torch.int32) == torch.int32
    assert tdtype.convert_dtype(np.float64) == torch.float64
    with pytest.raises(ValueError, match="unknown dtype"):
        tdtype.convert_dtype("float128")


def test_dtype_limits_are_the_jax_tables():
    assert tdl.DTYPE_LIMITS == {k: tdl.DtypeLimits(**vars(v))
                                for k, v in jdl.DTYPE_LIMITS.items()}
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float16,
                                                    "float16"),
                     (torch.int32, "float32")):
        assert tdl.limits_for(dt).name == name
        assert tdl.headroom_edges(dt, 4) == jdl.headroom_edges(name, 4)


def test_places():
    assert CPUPlace().device == torch.device("cpu")
    assert CPUPlace(0) == CPUPlace() and CPUPlace() != CUDAPlace(0)
    assert repr(CUDAPlace(1)) == "CUDAPlace(1)"


def test_cuda_place_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAPlace(0).device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_place()


def test_scope_parent_chain():
    root = Scope()
    kid = root.new_scope()
    root.set_tensor("w", torch.ones(2))
    kid.set_tensor("h", np.zeros(3, np.float32), lod=[[0, 1, 3]])
    assert kid.has_var("w") and not root.has_var("h")
    assert torch.equal(kid.get_tensor("w").array, torch.ones(2))
    assert kid.get_tensor("h").lod.levels[0].tolist() == [0, 1, 3]
    kid.erase("h")
    with pytest.raises(KeyError, match="'h'"):
        kid.get_tensor("h")
    assert list(root.local_var_names()) == ["w"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selected_rows_match_jax(seed):
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    height, k = 7, 12
    rows = rng.randint(0, height + 1, k).astype(np.int32)  # height: padding
    rows[:3] = [2, 2, height]
    vals = rng.randn(k, 3).astype(np.float32)
    j = jsr.SelectedRows(jnp.asarray(rows), jnp.asarray(vals), height)
    t = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), height)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    jm, tm = j.merge(), t.merge()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.to_dense().numpy(),
                               np.asarray(jm.to_dense()), rtol=1e-6,
                               atol=1e-6)


def test_validate_and_conv_name_their_items():
    main, _, _ = build_mlp("torch", None, (32,))
    with pytest.raises(NotImplementedError, match="A10"):
        main.validate()
    # the LeNet-style conv net raised naming A8 until the image path was
    # ported; it now builds (== the JAX program: tests/test_torch_image.py)
    with fresh(tprog) as (main, _):
        img = pt.layers.data("img", [1, 28, 28])
        label = pt.layers.data("label", [1], dtype="int64")
        _, loss, _ = tmnist.conv(img, label)
    types = [op.type for op in main.global_block().ops]
    assert types.count("conv2d") == 2 and types.count("pool2d") == 2
    assert loss.shape == ()


def _mlp_both(make_opt, after=None):
    """The MLP (784 -> 32) with ``make_opt(pkg).minimize`` (then
    ``after(pkg)``) through both packages: the port's and JAX's main and
    startup programs."""
    out = {}
    for side, pkg, mod, models in (("jax", jpt, jprog, jmnist),
                                   ("torch", pt, tprog, tmnist)):
        with fresh(mod) as (main, start):
            img = pkg.layers.data("img", [32])
            label = pkg.layers.data("label", [1], dtype="int64")
            _, loss, _ = models.mlp(img, label)
            make_opt(pkg).minimize(loss)
            if after is not None:
                after(pkg)
        out[side] = (main, start)
    return out["torch"], out["jax"]


def _same_programs(got, want):
    for t, j in zip(got, want):
        assert _describe(t) == _describe(j)
        assert t.fingerprint() == j.fingerprint()


# (the options raised, naming ROADMAP A3, until the port had them; the
# name is kept)
@pytest.mark.parametrize("kw", [
    {"regularization": "l2"}, {"global_clip_norm": 1.0},
    {"learning_rate": object()}])
def test_optimizer_options_of_a3_raise(kw):
    """``regularization=`` is kept and ignored and ``global_clip_norm=``
    appends the clip, each program equal to JAX's; a learning rate that
    is neither a number nor a schedule raises at ``minimize`` in both
    packages."""
    kw = dict({"learning_rate": 0.1}, **kw)
    if not isinstance(kw["learning_rate"], float):
        for mod, pkg in ((jprog, jpt), (tprog, pt)):
            with fresh(mod):
                x = pkg.layers.data("x", [4])
                loss = pkg.layers.mean(pkg.layers.fc(x, 2))
                with pytest.raises(TypeError):
                    pkg.optimizer.SGD(**kw).minimize(loss)
        return
    got, want = _mlp_both(lambda pkg: pkg.optimizer.SGD(**kw))
    _same_programs(got, want)
    types = [op.type for op in got[0].global_block().ops]
    assert types.count("squared_l2_norm") == (
        6 if "global_clip_norm" in kw else 0)
    assert "scale" not in types


OTHER_OPTIMIZERS = {
    "Adagrad": lambda m: m.optimizer.Adagrad(0.1),
    "Adamax": lambda m: m.optimizer.Adamax(0.1),
    "DecayedAdagrad": lambda m: m.optimizer.DecayedAdagrad(0.1),
    "AdaDelta": lambda m: m.optimizer.AdaDelta(0.1),
    "RMSProp": lambda m: m.optimizer.RMSProp(0.1),
    "Ftrl": lambda m: m.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "ModelAverage": lambda m: m.optimizer.SGD(0.1),
}


# (these raised, naming ROADMAP A3, until the port had them; the name is
# kept)
@pytest.mark.parametrize("name", list(OTHER_OPTIMIZERS))
def test_other_optimizers_raise_naming_a3(name):
    """Each of the other optimizers (and ``ModelAverage`` after an SGD
    ``minimize``) builds the MLP's main and startup programs of the JAX
    package: accumulators, update ops, their slots and attributes."""
    after = ((lambda pkg: pkg.optimizer.ModelAverage(0.99))
             if name == "ModelAverage" else None)
    got, want = _mlp_both(OTHER_OPTIMIZERS[name], after)
    _same_programs(got, want)
    types = [op.type for op in got[0].global_block().ops]
    want_op = {"DecayedAdagrad": "decayed_adagrad", "AdaDelta": "adadelta",
               "ModelAverage": "ema_update"}.get(name, name.lower())
    assert types.count(want_op) == 6


# (a per-parameter regularizer raised, naming ROADMAP A3, until the port
# had the decay ops; the name is kept)
def test_param_regularizer_raises_at_minimize():
    """``ParamAttr(regularizer=...)`` appends the decay ops at
    ``minimize``, as in the JAX package."""
    progs = {}
    for side, pkg, mod in (("jax", jpt, jprog), ("torch", pt, tprog)):
        with fresh(mod) as (main, start):
            x = pkg.layers.data("x", [4])
            attr = pkg.ParamAttr(regularizer=pkg.regularizer.L2Decay(1e-4))
            loss = pkg.layers.mean(pkg.layers.fc(x, 2, param_attr=attr))
            pkg.optimizer.SGD(0.1).minimize(loss)
        progs[side] = (main, start)
    _same_programs(progs["torch"], progs["jax"])
    assert [op.type for op in progs["torch"][0].global_block().ops] == [
        "mul", "elementwise_add", "mean", "backward", "scale", "sum", "sgd",
        "sgd"]
