"""The port's transformer LM, held against the JAX package.

A small config (vocab 128, d_model 32, 4 heads, 2 layers, d_ff 64) with
the JAX ``init_params`` copied across (``params_from_jax``) and the
same numpy token batches. JAX runs ``attn_impl="flash"`` through its
Pallas kernels in interpret mode; the port runs on the CPU, where the
flash wrappers take their plain versions. In fp32, with both
``attn_impl="flash"`` and ``"xla"``:

- ``forward`` logits (T 16 and 33), ``loss_fn`` and every gradient leaf:
  atol 1e-4 (the sums run in another order through two layers);
- three ``make_train_step`` steps (lr 0.1, momentum 0.9): each loss and
  every param after the third step, atol 1e-4;
- ``make_kstep_train_step`` with K=3 against JAX's kstep (atol 1e-4),
  and against three sequential port steps (bit for bit).

A bf16 forward + loss is held at atol 5e-2 on the logits and 1e-2 on
the loss: each matmul rounds to bf16 (2^-8 relative) in another order
on the two sides, through two layers and the tied head.

A wider config with head_dim 128 (d_model 256, 2 heads), the flash
kernels' widest capacity, holds the loss and every gradient leaf at the
same atol 1e-4, with both ``attn_impl`` values.

The JAX oracles are computed once per module (jitted) and cached, so
the file stays a few tens of seconds. The kernel-vs-plain training step
needs a card and skips without one.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import transformer as tt

SMALL = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
IMPLS = ["xla", "flash"]
TOL = 1e-4
BF16_LOGIT_TOL = 5e-2
BF16_LOSS_TOL = 1e-2
LR = 0.1
STEP_T = 16
K = 3


@pytest.fixture(scope="module")
def jt():
    """The JAX package's transformer module."""
    pytest.importorskip("jax")
    from paddle_tpu.models import transformer
    return transformer


def _jcfg(jt, impl, bf16=False, **kw):
    import jax.numpy as jnp
    return jt.TransformerConfig(**SMALL, attn_impl=impl,
                                dtype=jnp.bfloat16 if bf16 else jnp.float32,
                                **kw)


def _tcfg(impl, bf16=False, **kw):
    return tt.TransformerConfig(**SMALL, attn_impl=impl,
                                dtype=torch.bfloat16 if bf16
                                else torch.float32, **kw)


def _batch(T, seed, lead=()):
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (2, T)
    return (rng.integers(0, SMALL["vocab_size"], shape).astype(np.int32),
            rng.integers(0, SMALL["vocab_size"], shape).astype(np.int32))


def _np_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree):
    """(path, array) pairs of a params tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, a) for k in sorted(tree)
                for p, a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}" if p else str(i), a)
                for i, item in enumerate(tree) for p, a in _leaves(item)]
    return [("", tree)]


def _assert_trees_close(got, want, tol):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_p, b) in zip(g, w):
        a = a.detach().float().numpy() if torch.is_tensor(a) else a
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                                   rtol=0, err_msg=path)


# d_model // n_heads = 128: the flash kernels' widest head_dim
WIDE = dict(SMALL, d_model=256, n_heads=2, d_ff=128)


@pytest.fixture(scope="module")
def jparams(jt):
    import jax
    return _np_tree(jt.init_params(jax.random.PRNGKey(0),
                                   _jcfg(jt, "xla")))


class _Oracle:
    """JAX results, computed on first use and kept for the module."""

    def __init__(self, jt, np_params):
        self.jt, self.np_params, self.cache = jt, np_params, {}

    def get(self, key, make):
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]

    def params(self):
        import jax.numpy as jnp
        import jax
        return jax.tree_util.tree_map(jnp.asarray, self.np_params)

    def logits(self, impl, T, bf16=False):
        import jax
        import jax.numpy as jnp

        def make():
            cfg = _jcfg(self.jt, impl, bf16)
            tok, tgt = _batch(T, 1)
            fn = jax.jit(lambda p, a, b: (
                self.jt.forward(p, a, cfg),
                self.jt.loss_fn(p, a, b, cfg)))
            lg, loss = fn(self.params(), jnp.asarray(tok), jnp.asarray(tgt))
            return np.array(lg, np.float32), float(loss)
        return self.get(("logits", impl, T, bf16), make)

    def loss_and_grads(self, impl):
        import jax
        import jax.numpy as jnp

        def make():
            cfg = _jcfg(self.jt, impl)
            tok, tgt = _batch(33, 2)
            vg = jax.jit(jax.value_and_grad(
                lambda p, a, b: self.jt.loss_fn(p, a, b, cfg)))
            loss, grads = vg(self.params(), jnp.asarray(tok),
                             jnp.asarray(tgt))
            return float(loss), _np_tree(grads)
        return self.get(("grads", impl), make)

    def steps(self, impl):
        import jax
        import jax.numpy as jnp

        def make():
            cfg = _jcfg(self.jt, impl)
            step = jax.jit(self.jt.make_train_step(cfg, lr=LR))
            toks, tgts = _batch(STEP_T, 3, lead=(K,))
            p = self.params()
            v = jax.tree_util.tree_map(jnp.zeros_like, p)
            losses = []
            for i in range(K):
                p, v, loss = step(p, v, jnp.asarray(toks[i]),
                                  jnp.asarray(tgts[i]))
                losses.append(float(loss))
            return losses, _np_tree(p), _np_tree(v)
        return self.get(("steps", impl), make)

    def kstep(self, impl):
        import jax
        import jax.numpy as jnp

        def make():
            cfg = _jcfg(self.jt, impl)
            fn = self.jt.make_kstep_train_step(cfg, lr=LR)
            toks, tgts = _batch(STEP_T, 3, lead=(K,))
            p = self.params()
            v = jax.tree_util.tree_map(jnp.zeros_like, p)
            p, v, losses = fn(p, v, jnp.asarray(toks), jnp.asarray(tgts))
            return np.array(losses), _np_tree(p)
        return self.get(("kstep", impl), make)


@pytest.fixture(scope="module")
def oracle(jt, jparams):
    return _Oracle(jt, jparams)


def _port(jparams):
    return params_from_jax(jparams, "cpu")


def _zeros_like(tree):
    return tt._rebuild(tree, [torch.zeros_like(x) for x in tt._leaves(tree)])


def _grads(params, tok, tgt, cfg):
    leaves = tt._leaves(params)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    loss = tt.loss_fn(tt._rebuild(params, live), tok, tgt, cfg)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tt._rebuild(params, grads)


def _tb(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("T", [16, 33])
def test_forward_and_loss_match_jax(oracle, jparams, impl, T):
    want_logits, want_loss = oracle.logits(impl, T)
    tok, tgt = _tb(*_batch(T, 1))
    cfg = _tcfg(impl)
    with torch.no_grad():
        logits = tt.forward(_port(jparams), tok, cfg)
        loss = tt.loss_fn(_port(jparams), tok, tgt, cfg)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, T, SMALL["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=TOL, rtol=0)
    assert abs(float(loss) - want_loss) <= TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_every_grad_match_jax(oracle, jparams, impl):
    want_loss, want_grads = oracle.loss_and_grads(impl)
    tok, tgt = _tb(*_batch(33, 2))
    loss, grads = _grads(_port(jparams), tok, tgt, _tcfg(impl))
    assert abs(float(loss) - want_loss) <= TOL
    _assert_trees_close(grads, want_grads, TOL)


@pytest.fixture(scope="module")
def wide_oracle(jt):
    """The WIDE config's params and, per ``attn_impl``, JAX's loss and
    gradients on one batch (T 33), computed once for the module."""
    import jax
    import jax.numpy as jnp
    cfgs = {impl: jt.TransformerConfig(**WIDE, attn_impl=impl,
                                       dtype=jnp.float32)
            for impl in IMPLS}
    params = _np_tree(jt.init_params(jax.random.PRNGKey(1), cfgs["xla"]))
    tok, tgt = (jnp.asarray(a) for a in _batch(33, 8))
    cache = {}

    def get(impl):
        if impl not in cache:
            vg = jax.jit(jax.value_and_grad(
                lambda p, a, b: jt.loss_fn(p, a, b, cfgs[impl])))
            loss, grads = vg(jax.tree_util.tree_map(jnp.asarray, params),
                             tok, tgt)
            cache[impl] = float(loss), _np_tree(grads)
        return cache[impl]
    return params, get


@pytest.mark.parametrize("impl", IMPLS)
def test_head_dim_128_loss_and_every_grad_match_jax(wide_oracle, impl):
    jp, get = wide_oracle
    want_loss, want_grads = get(impl)
    tok, tgt = _tb(*_batch(33, 8))
    cfg = tt.TransformerConfig(**WIDE, attn_impl=impl, dtype=torch.float32)
    assert cfg.head_dim == 128
    loss, grads = _grads(_port(jp), tok, tgt, cfg)
    assert abs(float(loss) - want_loss) <= TOL
    _assert_trees_close(grads, want_grads, TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_three_train_steps_match_jax(oracle, jparams, impl):
    want_losses, want_params, want_vel = oracle.steps(impl)
    step = tt.make_train_step(_tcfg(impl), lr=LR)
    toks, tgts = _tb(*_batch(STEP_T, 3, lead=(K,)))
    params = _port(jparams)
    vel = _zeros_like(params)
    for i in range(K):
        out_p, out_v, loss = step(params, vel, toks[i], tgts[i])
        assert out_p is params and out_v is vel       # updated in place
        assert loss.dim() == 0 and not loss.requires_grad
        assert abs(float(loss) - want_losses[i]) <= TOL, i
    _assert_trees_close(params, want_params, TOL)
    _assert_trees_close(vel, want_vel, TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_kstep_matches_jax_and_sequential_steps(oracle, jparams, impl):
    want_losses, want_params = oracle.kstep(impl)
    cfg = _tcfg(impl)
    toks, tgts = _tb(*_batch(STEP_T, 3, lead=(K,)))
    params = _port(jparams)
    params, vel, losses = tt.make_kstep_train_step(cfg, lr=LR)(
        params, _zeros_like(params), toks, tgts)
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), want_losses, atol=TOL,
                               rtol=0)
    _assert_trees_close(params, want_params, TOL)
    seq = _port(jparams)
    seq_vel = _zeros_like(seq)
    step = tt.make_train_step(cfg, lr=LR)
    for i in range(K):
        _p, _v, loss = step(seq, seq_vel, toks[i], tgts[i])
        assert torch.equal(loss, losses[i])
    for (path, a), (_q, b) in zip(_leaves(params), _leaves(seq)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_forward_and_loss_match_jax(oracle, jparams, impl):
    want_logits, want_loss = oracle.logits(impl, 33, bf16=True)
    tok, tgt = _tb(*_batch(33, 1))
    cfg = _tcfg(impl, bf16=True)
    with torch.no_grad():
        logits = tt.forward(_port(jparams), tok, cfg)
        loss = tt.loss_fn(_port(jparams), tok, tgt, cfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=BF16_LOGIT_TOL, rtol=0)
    assert abs(float(loss) - want_loss) <= BF16_LOSS_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_remat_gives_the_same_loss_and_grads(jparams, impl):
    tok, tgt = _tb(*_batch(33, 4))
    loss, grads = _grads(_port(jparams), tok, tgt, _tcfg(impl))
    r_loss, r_grads = _grads(_port(jparams), tok, tgt,
                             _tcfg(impl, remat=True))
    assert torch.equal(loss, r_loss)
    for (path, a), (_q, b) in zip(_leaves(grads), _leaves(r_grads)):
        assert torch.equal(a, b), path


def test_flash_reference_impl_equals_flash_on_the_cpu(jparams):
    tok, tgt = _tb(*_batch(16, 5))
    loss, grads = _grads(_port(jparams), tok, tgt, _tcfg("flash"))
    r_loss, r_grads = _grads(_port(jparams), tok, tgt,
                             _tcfg("flash_reference"))
    assert torch.equal(loss, r_loss)
    for (path, a), (_q, b) in zip(_leaves(grads), _leaves(r_grads)):
        assert torch.equal(a, b), path


def test_cpu_training_counts_no_kernel_launches(jparams):
    before = dict(tk.LAUNCHES)
    tok, tgt = _tb(*_batch(16, 6))
    params = _port(jparams)
    tt.make_train_step(_tcfg("flash"), lr=LR)(params, _zeros_like(params),
                                              tok, tgt)
    assert tk.LAUNCHES == before


_A9_CALLS = {
    "moe_init": lambda: tt.init_params(_tcfg("xla", moe_experts=2),
                                       device="cpu"),
    "moe_forward": lambda: tt.forward({}, torch.zeros(1, 2, dtype=torch.long),
                                      _tcfg("xla", moe_experts=2)),
    "ring_step": lambda: tt.make_train_step(_tcfg("ring")),
    "ring_kstep": lambda: tt.make_kstep_train_step(_tcfg("ring")),
    "mesh_forward": lambda: tt.forward({}, torch.zeros(1, 2,
                                                       dtype=torch.long),
                                       _tcfg("xla"), mesh=object()),
    "param_specs": lambda: tt.param_specs(_tcfg("xla")),
    "sharded": lambda: tt.make_sharded_train_step(object(), _tcfg("xla")),
    "multislice": lambda: tt.make_multislice_train_step(object(),
                                                        _tcfg("xla")),
    "stack": lambda: tt.stack_layer_params({}),
    "stacked_specs": lambda: tt.stacked_param_specs(_tcfg("xla")),
    "pipeline_loss": lambda: tt.pipeline_loss_fn({}, None, None,
                                                 _tcfg("xla"), object(), 2),
    "pipeline": lambda: tt.make_pipeline_train_step(object(), _tcfg("xla")),
}


@pytest.mark.parametrize("what", sorted(_A9_CALLS))
def test_a9_options_raise(what):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        _A9_CALLS[what]()


def test_unknown_attn_impl_raises(jparams):
    with pytest.raises(ValueError, match="attn_impl"):
        tt.forward(_port(jparams), torch.zeros(1, 4, dtype=torch.long),
                   _tcfg("dense"))


def test_init_params_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(_tcfg("flash"))


def test_init_params_has_the_jax_layout(jparams):
    params = tt.init_params(_tcfg("flash"), seed=3, device="cpu")
    got, want = _leaves(params), _leaves(jparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_p, b) in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, path
    again = tt.init_params(_tcfg("flash"), seed=3, device="cpu")
    for (path, a), (_p, b) in zip(got, _leaves(again)):
        assert torch.equal(a, b), path
    assert abs(float(params["embed"].std()) * np.sqrt(32) - 1.0) < 0.1


def test_params_from_jax_takes_the_nested_tree(jparams):
    tree = dict(jparams)
    tree["layers"] = [dict(lp) for lp in jparams["layers"]]
    tree["layers"][0]["q8"] = np.arange(-4, 4, dtype=np.int8)
    port = params_from_jax(tree, "cpu")
    assert isinstance(port["layers"], list) and len(port["layers"]) == 2
    got, want = _leaves(port), _leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_p, b) in zip(got, want):
        assert a.dtype == torch.from_numpy(b).dtype, path
        assert np.array_equal(a.numpy(), b), path
    with pytest.raises(TypeError, match="layers/1/bad"):
        params_from_jax({"layers": [{}, {"bad": np.arange(3)}]}, "cpu")


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_train_step_kernels_match_plain_on_card(cuda_device, bf16):
    """One step's loss and gradients with the flash kernels against the
    same step through their plain versions (``flash_reference``), on the
    card: fp32 relative L2 <= 1e-4, bf16 <= 2e-2."""
    cfg = dict(SMALL, d_model=128, n_heads=2, max_len=160)
    dt = torch.bfloat16 if bf16 else torch.float32
    kcfg = tt.TransformerConfig(**cfg, dtype=dt, attn_impl="flash")
    pcfg = tt.TransformerConfig(**cfg, dtype=dt, attn_impl="flash_reference")
    params = tt.init_params(kcfg, seed=1, device=cuda_device)
    tok, tgt = (t.to(cuda_device) for t in _tb(*_batch(150, 7)))
    tk.reset_launches()
    loss, grads = _grads(params, tok, tgt, kcfg)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert tk.LAUNCHES[name] == cfg["n_layers"], name
    r_loss, r_grads = _grads(params, tok, tgt, pcfg)
    tol = 2e-2 if bf16 else 1e-4
    assert abs(float(loss) - float(r_loss)) <= tol * abs(float(r_loss))
    for (path, a), (_q, b) in zip(_leaves(grads), _leaves(r_grads)):
        rel = float(torch.linalg.vector_norm((a - b).float())
                    / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
        assert rel <= tol, (path, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_head_dim_128_train_step_kernels_match_plain_on_card(cuda_device,
                                                             bf16):
    """One step at head_dim 128 (d_model 256, 2 heads), the flash
    kernels' widest capacity: loss and gradients with the kernels
    against ``flash_reference`` on the card, fp32 relative L2 <= 1e-4,
    bf16 <= 2e-2."""
    cfg = dict(WIDE, max_len=160)
    dt = torch.bfloat16 if bf16 else torch.float32
    kcfg = tt.TransformerConfig(**cfg, dtype=dt, attn_impl="flash")
    pcfg = tt.TransformerConfig(**cfg, dtype=dt, attn_impl="flash_reference")
    assert kcfg.head_dim == 128
    params = tt.init_params(kcfg, seed=2, device=cuda_device)
    tok, tgt = (t.to(cuda_device) for t in _tb(*_batch(150, 9)))
    tk.reset_launches()
    loss, grads = _grads(params, tok, tgt, kcfg)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert tk.LAUNCHES[name] == cfg["n_layers"], name
    r_loss, r_grads = _grads(params, tok, tgt, pcfg)
    tol = 2e-2 if bf16 else 1e-4
    assert abs(float(loss) - float(r_loss)) <= tol * abs(float(r_loss))
    for (path, a), (_q, b) in zip(_leaves(grads), _leaves(r_grads)):
        rel = float(torch.linalg.vector_norm((a - b).float())
                    / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
        assert rel <= tol, (path, rel)
