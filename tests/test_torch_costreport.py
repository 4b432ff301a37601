"""The port's cost plane (``obs/costreport.py``, ``Executor.cost_report``
and the kernel FLOPs ledger) held against the JAX package's on the CPU.

- One step of the MNIST MLP (784-128-64-10, batch 64, Adam): the port's
  ``CostReport.flops`` is 29,081,600 exactly (the analytic 2·M·N·K sum
  of its eight products, all ``dot``), and the JAX Executor's
  ``flops_xla`` on the same program lies within [1.0, 1.1] of it (XLA
  also counts elementwise work). JAX's op kinds and HLO walk are not an
  oracle (ROADMAP C1). A K-step report counts K steps.
- ``CostReport`` has the JAX fields, ``to_dict`` keys and cost table.
- Each ledger formula (``*_flops`` in ``kernels/fused_rnn.py``,
  ``flash_attention.py``, ``paged_attention.py``) equals the FLOPs the
  JAX function it replaces notes (its Pallas call traced with
  ``interpret=False`` under ``jax.eval_shape``, the JAX ledger armed).
- The wrappers' CUDA branches (with the launch and the card's queries
  stubbed) note once per JAX function, B14 and B15 each once; the CPU
  branches note nothing; the ledger is thread-local and re-armed by a
  kernel's autograd backward on another thread.
- ``cost_report`` writes nothing back: the scope and the step counter
  are as before, and the next step's loss is the one without the call.
- On the flagship classifier at vocab 100, emb 16, hidden 16, T 8, B 4
  (the plain versions on the CPU), the counted step lies within 5 % of
  the ledger formulas' sum, as the card's kernel step must.
"""
import functools
import importlib
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core import scope as jscope
from paddle_tpu.framework import program as jprog
from paddle_tpu.obs import costreport as jcr

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.framework import program as tprog
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import fused_rnn as tfr
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.obs import costreport as tcr

jfr = importlib.import_module("paddle_tpu.kernels.fused_rnn")
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")

MLP_FLOPS = 29_081_600


@pytest.fixture(autouse=True)
def clean_state():
    for m in (jprog, tprog):
        m.fresh_programs()
    for s in (jscope, tscope):
        s.reset_global_scope()
    yield
    for m in (jprog, tprog):
        m.fresh_programs()
    for s in (jscope, tscope):
        s.reset_global_scope()


def _mlp(pkg):
    img = pkg.layers.data("img", [784])
    label = pkg.layers.data("label", [1], dtype="int64")
    h = pkg.layers.fc(pkg.layers.fc(img, 128, act="relu"), 64, act="relu")
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        pkg.layers.fc(h, 10), label))
    pkg.optimizer.Adam(0.01).minimize(loss)
    return loss


def _mlp_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(64, 784).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}


def test_mlp_step_flops_exact_and_beside_xla():
    loss = _mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rep = exe.cost_report(feed=_mlp_feed(), fetch_list=[loss])
    assert rep.flops == rep.flops_hlo == MLP_FLOPS
    assert rep.flops_xla == 0 and rep.flops_kernel == 0
    assert rep.steps == 1 and rep.flops_per_step == MLP_FLOPS
    assert set(rep.op_kinds) == {"dot"}
    assert rep.op_kinds["dot"]["flops_share"] == 1.0
    assert rep.argument_bytes > 784 * 128 * 4 and rep.temp_bytes == 0
    multi = exe.cost_report(feeds=[_mlp_feed(1), _mlp_feed(2),
                                   _mlp_feed(3)], fetch_list=[loss])
    assert multi.program == "run_multi" and multi.steps == 3
    assert multi.flops == 3 * MLP_FLOPS
    assert multi.flops_per_step == MLP_FLOPS
    jloss = _mlp(jpt)
    jexe = jpt.Executor(jpt.CPUPlace(), telemetry=jpt.obs.Telemetry(
        trace_path=None, collect_hlo=True))
    jexe.run(jpt.default_startup_program())
    jrep = jexe.cost_report(feed=_mlp_feed(), fetch_list=[jloss])
    assert 1.0 <= jrep.flops_xla / rep.flops <= 1.1


def test_report_fields_and_table_match_jax():
    kinds = {"dot": {"flops": 6e9, "bytes": 0.0, "count": 3,
                     "flops_share": 0.75, "bytes_share": 0.0},
             "custom": {"flops": 2e9, "bytes": 0.0, "count": 2,
                        "flops_share": 0.25, "bytes_share": 0.0}}
    fields = dict(program="run", steps=2, flops_hlo=6e9, flops_kernel=2e9,
                  flops=8e9, argument_bytes=10, output_bytes=20,
                  temp_bytes=30, peak_hbm_bytes=60, op_kinds=kinds)
    t, j = tcr.CostReport(**fields), jcr.CostReport(**fields)
    assert t.to_dict() == j.to_dict()
    assert tcr.format_cost_table(t) == jcr.format_cost_table(j)
    assert tcr.CostReport().to_dict().keys() == jcr.CostReport().to_dict() \
        .keys()
    rep = tcr.harvest_cost_report({"aten.mm": 3e9, "aten.convolution": 1e9,
                                   "aten.addmm": 1e9}, program="run",
                                  steps=2, kernel_flops=5e9,
                                  kernel_notes=4)
    assert rep.flops == 10e9 and rep.flops_hlo == 5e9
    assert rep.flops_per_step == 5e9
    assert {k: v["count"] for k, v in rep.op_kinds.items()} == {
        "dot": 2, "conv": 1, "custom": 4}
    assert sum(v["flops_share"] for v in rep.op_kinds.values()) == \
        pytest.approx(1.0)


def _jax_noted(fn, *shapes, **static):
    import jax
    import jax.numpy as jnp
    args = [jax.ShapeDtypeStruct(s, jnp.int32 if d == "i" else
                                 jnp.float32) for s, d in shapes]
    with jcr.flops_ledger() as box:
        jax.eval_shape(functools.partial(fn, interpret=False, **static),
                       *args)
    return box["flops"]


T_, B_, E_, D_ = 5, 8, 64, 128
H_, TQ, TK, HD = 2, 48, 80, 32
S_, P_, BS, N_, G_ = 3, 4, 16, 24, 6


def _f(*s):
    return (s, "f")


def _i(*s):
    return (s, "i")


LEDGER = {
    "B10": (tfr.lstm_fwd_flops(T_, B_, D_), jfr._lstm_fwd_call,
            [_f(T_, B_, 4 * D_), _f(D_, 4 * D_), _f(B_, 1), _f(B_, D_),
             _f(B_, D_)], {}),
    "B11": (tfr.lstm_bwd_flops(T_, B_, D_), jfr._lstm_bwd_call,
            [_f(T_, B_, 4 * D_), _f(T_, B_, D_), _f(T_, B_, D_),
             _f(D_, 4 * D_), _f(B_, 1), _f(B_, D_), _f(B_, D_),
             _f(T_, B_, D_), _f(T_, B_, D_)], {}),
    "B12": (tfr.gru_fwd_flops(T_, B_, D_), jfr._gru_fwd_call,
            [_f(T_, B_, 3 * D_), _f(D_, 3 * D_), _f(B_, 1), _f(B_, D_)],
            {}),
    "B13": (tfr.gru_bwd_flops(T_, B_, D_), jfr._gru_bwd_call,
            [_f(T_, B_, 3 * D_), _f(T_, B_, D_), _f(D_, 3 * D_), _f(B_, 1),
             _f(B_, D_), _f(T_, B_, D_)], {}),
    "B14": (tfr.lstm_proj_fwd_flops(T_, B_, E_, D_),
            jfr._lstm_proj_fwd_call,
            [_f(T_, B_, E_), _f(E_, 4 * D_), _f(4 * D_), _f(D_, 4 * D_),
             _f(B_, 1), _f(B_, D_), _f(B_, D_)], {}),
    "B15": (tfr.lstm_proj_bwd_flops(T_, B_, E_, D_),
            jfr._lstm_proj_bwd_call,
            [_f(T_, B_, E_), _f(T_, B_, 4 * D_), _f(T_, B_, D_),
             _f(T_, B_, D_), _f(E_, 4 * D_), _f(D_, 4 * D_), _f(B_, 1),
             _f(B_, D_), _f(B_, D_), _f(T_, B_, D_), _f(T_, B_, D_)], {}),
    "B8": (tfa.flash_fwd_flops(2, H_, TQ, TK, HD, False), jfa._fwd_call,
           [_f(2, H_, TQ, HD), _f(2, H_, TK, HD), _f(2, H_, TK, HD)],
           dict(causal=False, sm_scale=0.5, block_q=16, block_k=16)),
    "B8 causal": (tfa.flash_fwd_flops(2, H_, TQ, TK, HD, True),
                  jfa._fwd_call,
                  [_f(2, H_, TQ, HD), _f(2, H_, TK, HD), _f(2, H_, TK, HD)],
                  dict(causal=True, sm_scale=0.5, block_q=16, block_k=16)),
    "B9": (tfa.flash_bwd_flops(2, H_, TQ, TK, HD, True), jfa._bwd_call,
           [_f(2, H_, TQ, HD), _f(2, H_, TK, HD), _f(2, H_, TK, HD),
            _f(2, H_, TQ, HD), _f(2, H_, TQ), _f(2, H_, TQ, HD)],
           dict(causal=True, sm_scale=0.5, block_q=16, block_k=16)),
    "B1": (tpa.paged_mixed_flops(7, P_, H_, BS, HD), jpa._paged_mixed_call,
           [_f(7, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _i(S_, P_), _i(7), _i(7)], dict(sm_scale=0.5)),
    "B2": (tpa.paged_mixed_flops(7, P_, H_, BS, HD),
           jpa._paged_mixed_call_quant,
           [_f(7, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _f(N_, H_), _f(N_, H_), _i(S_, P_), _i(7), _i(7)],
           dict(sm_scale=0.5)),
    "B3": (tpa.paged_decode_flops(S_, P_, H_, BS, HD), jpa._paged_call,
           [_f(S_, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _i(S_, P_), _i(S_)], dict(sm_scale=0.5)),
    "B4": (tpa.paged_decode_flops(S_, P_, H_, BS, HD),
           jpa._paged_call_quant,
           [_f(S_, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _f(N_, H_), _f(N_, H_), _i(S_, P_), _i(S_)],
           dict(sm_scale=0.5)),
    "B5": (tpa.paged_chunk_flops(S_, G_, P_, H_, BS, HD),
           jpa._paged_chunk_call,
           [_f(S_, G_, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _i(S_, P_), _i(S_, G_)], dict(sm_scale=0.5)),
    "B6": (tpa.paged_chunk_flops(S_, G_, P_, H_, BS, HD),
           jpa._paged_chunk_call_quant,
           [_f(S_, G_, H_, HD), _f(N_, H_, BS, HD), _f(N_, H_, BS, HD),
            _f(N_, H_), _f(N_, H_), _i(S_, P_), _i(S_, G_)],
           dict(sm_scale=0.5)),
}


@pytest.mark.parametrize("row", list(LEDGER))
def test_ledger_formula_matches_the_jax_note(row):
    ours, fn, shapes, static = LEDGER[row]
    assert ours > 0
    assert ours == _jax_noted(fn, *shapes, **static)


@pytest.fixture
def as_on_a_card(monkeypatch):
    """fused_rnn's and flash_attention's wrappers as on a card: the
    launches and the card's queries stubbed, each launch recorded."""
    calls = []

    def launch(name, lane, pointers, ints, dev, entry=None, also=()):
        calls.append(name)

    monkeypatch.setattr(tfr, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(tfr, "_check_cuda", lambda *a, **k: 0)
    monkeypatch.setattr(tfr, "_cluster_plan",
                        lambda dtype, B, D, dev, ng=4:
                        tfr.lstm_cluster_plan(dtype, B, D, ng=ng))
    monkeypatch.setattr(tfr, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(tfr, "_launch", launch)
    monkeypatch.setattr(tfa, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(tfa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tfa, "_launch",
                        lambda entry, *a, **k: calls.append(entry))
    return calls


def _rnn_case(T, B, D, E=0, ng=4, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g).to(dtype)
    c = {"x": r(T, B, ng * D), "w": r(D, ng * D), "h0": r(B, D),
         "c0": r(B, D), "dhs": r(T, B, D), "dcs": r(T, B, D),
         "gates": r(T, B, ng * D), "cs": r(T, B, D), "hs": r(T, B, D),
         "lens": torch.full((B, 1), float(T))}
    if E:
        c.update(xe=r(T, B, E), wx=r(E, ng * D), b=r(ng * D))
    return c


def test_cuda_branches_note_once_per_jax_function(as_on_a_card):
    T, B, D, E = 4, 8, 512, 128
    c = _rnn_case(T, B, D, E)
    g = _rnn_case(T, B, D, ng=3)
    q = torch.randn(2, 3, 16, 32)
    k = torch.randn(2, 3, 24, 32)
    cases = [
        (lambda: tfr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], c["w"],
                                   c["lens"], c["h0"], c["c0"]),
         tfr.lstm_proj_fwd_flops(T, B, E, D)),
        (lambda: tfr.lstm_proj_bwd(c["xe"], c["gates"], c["hs"], c["cs"],
                                   c["wx"], c["w"], c["lens"], c["h0"],
                                   c["c0"], c["dhs"], c["dcs"]),
         tfr.lstm_proj_bwd_flops(T, B, E, D)),
        (lambda: tfr.lstm_fwd(c["x"], c["w"], c["lens"], c["h0"], c["c0"]),
         tfr.lstm_fwd_flops(T, B, D)),
        (lambda: tfr.lstm_bwd(c["gates"], c["hs"], c["cs"], c["w"],
                              c["lens"], c["h0"], c["c0"], c["dhs"],
                              c["dcs"]), tfr.lstm_bwd_flops(T, B, D)),
        (lambda: tfr.gru_fwd(g["x"], g["w"], g["lens"], g["h0"]),
         tfr.gru_fwd_flops(T, B, D)),
        (lambda: tfr.gru_bwd(g["gates"], g["hs"], g["w"], g["lens"],
                             g["h0"], g["dhs"]), tfr.gru_bwd_flops(T, B, D)),
        (lambda: tfa.flash_attention_fwd(q, k, k, True, 0.5),
         tfa.flash_fwd_flops(2, 3, 16, 24, 32, True)),
        (lambda: tfa.flash_attention_bwd(q, k, k, q, q[..., 0], q[..., 0],
                                         False, 0.5),
         tfa.flash_bwd_flops(2, 3, 16, 24, 32, False)),
    ]
    for call, want in cases:
        n_launch = len(as_on_a_card)
        with tcr.flops_ledger() as box:
            call()
        assert box == {"flops": want, "notes": 1}
        assert len(as_on_a_card) > n_launch    # the launches it replaces
    assert tcr.current_ledger() is None


def test_cpu_branches_note_nothing():
    c = _rnn_case(5, 3, 16, 8, dtype=torch.float32)
    for t in c.values():
        t.requires_grad_(t.is_floating_point())
    q = torch.randn(1, 2, 6, 8, requires_grad=True)
    with tcr.flops_ledger() as box:
        hs, cs = tfr.lstm_scan_proj(c["xe"], c["wx"], c["b"], c["w"],
                                    c["lens"], c["h0"], c["c0"])
        out = tk.flash_attention.flash_attention(q, q, q, causal=True)
        (hs.sum() + cs.sum() + out.sum()).backward()
    assert box == {"flops": 0.0, "notes": 0}


def test_ledger_is_thread_local_and_rearmed_by_the_saved_box():
    seen = {}
    with tcr.flops_ledger() as box:
        tcr.note_flops(5)

        def other():
            tcr.note_flops(7)                 # not armed here
            seen["unarmed"] = tcr.current_ledger()
            with tk.ledger_scope(box):        # a backward's re-arm
                tk.note_flops(11)
            seen["after"] = tcr.current_ledger()
        t = threading.Thread(target=other)
        t.start()
        t.join()
        saved = tk.saved_ledger()
    tcr.note_flops(13)                        # disarmed: dropped
    assert box == {"flops": 16.0, "notes": 2} and saved is box
    assert seen == {"unarmed": None, "after": None}
    with tk.ledger_scope(None):
        assert tcr.current_ledger() is None


def test_cost_report_writes_nothing_back():
    loss = _mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    exe.run(feed=_mlp_feed(5), fetch_list=[loss])
    scope = tscope.global_scope()
    before = {n: scope.find_var(n).array.clone()
              for n in scope.local_var_names()}
    ctr = exe._step_ctr
    exe.cost_report(feed=_mlp_feed(6), fetch_list=[loss])
    exe.cost_report(feeds=[_mlp_feed(6)] * 2)
    assert exe._step_ctr == ctr
    assert set(scope.local_var_names()) == set(before)
    for n, v in before.items():
        assert torch.equal(scope.find_var(n).array, v), n
    got = exe.run(feed=_mlp_feed(6), fetch_list=[loss])[0]
    tprog.fresh_programs()
    tscope.reset_global_scope()
    loss = _mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    exe.run(feed=_mlp_feed(5), fetch_list=[loss])
    assert np.array_equal(exe.run(feed=_mlp_feed(6),
                                  fetch_list=[loss])[0], got)


def test_flagship_plain_step_is_the_ledgers_sum():
    """The classifier's counted CPU step (the plain versions' products,
    which the counter sees) against the FLOPs the card's B14/B15 would
    note for the same two layers: within 5 %, as the card's kernel and
    plain steps must agree."""
    from paddle_tpu_torch.models import text
    V, EMB, HID, T, B = 100, 16, 16, 8, 4
    words = pt.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pt.layers.data("label", [1], dtype="int64")
    _, loss, _ = text.lstm_benchmark_net(words, label, input_dim=V,
                                         emb_dim=EMB, hid_dim=HID,
                                         num_layers=2, fused_proj=True)
    pt.optimizer.Adam(0.002).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())
    rng = np.random.RandomState(0)
    feed = pt.DataFeeder([words, label]).feed(
        [(rng.randint(0, V, T).tolist(), int(rng.randint(0, 2)))
         for _ in range(B)])
    rep = exe.cost_report(feed=feed, fetch_list=[loss])
    ledger = sum(f(T, B, e, HID) for e in (EMB, HID)
                 for f in (tfr.lstm_proj_fwd_flops,
                           tfr.lstm_proj_bwd_flops))
    assert rep.flops_kernel == 0
    assert 0.95 <= rep.flops / ledger <= 1.05, (rep.flops, ledger)
