"""The LSTM recurrences' grid route (bf16 past D 512: W resident across a
group of 16-CTA clusters, B10/B11/B14/B15 at D 768, 1024 and 1280).

On the CPU:

- ``lstm_cluster_plan``'s grid route counted by hand at D 1024 and 1280
  (units a CTA, clusters a group, row tiles, shared memory), the D it
  refuses (D 640, no multiple of 256; D 1536, whose CTAs would need
  253,440 bytes; a card that holds fewer clusters than the group), and
  the parent's answers where nothing changed: fp32, D <= 512 and the GRU
  (``ng`` 3, which streams past D 512);
- the wrappers' wiring with the launch recorded (the device kind and the
  plan patched, as on a card): each of B10, B11's recurrence, B14 and
  B15's recurrence at D 1024 launches its grid entry once with the
  kernels' scratch (fp32 carries, the backward's fp32 slots, a zeroed
  step counter), counted under its wrapper's and its ``_grid`` name, the
  passes around B14/B15 as on the resident route; a failed launch raises
  and nothing is retried on another route; ``lstm_cluster_fwd`` /
  ``lstm_cluster_bwd`` raise on a D that streams;
- the plain versions at D 1024 (T 3, B 4, E 128, ragged lengths with 0
  and T) against the JAX package's Pallas kernels in interpret mode
  (``_lstm_fwd_call``, ``_lstm_bwd_call``, ``_lstm_proj_fwd_call``,
  ``_lstm_proj_bwd_call``), in bf16 at ``tests/test_torch_lstm.py``'s
  tolerances: the route's decomposition (B14: xg for every step in fp32,
  then the recurrence; B15: the recurrence with db, then dxe) and B10 /
  B11 as the same recurrences.

The kernel-vs-plain cases need a card and skip without one (``cuda``
marker): D 1024 and 1280 at B 8, 128 and a ragged 130, each output
within chip_smoke.py's bf16 gate of the fp32 plain result, counted under
the ``_grid`` names, two launches bit-equal, B10 bit-equal to B14's
recurrence on float(x) and B11's outputs to B15's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import fused_rnn as tfr

BF, F32 = torch.bfloat16, torch.float32
BF16_FWD_TOL = 2e-2
BF16_GRAD_TOL = 5e-2


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


# --------------------------------------------------------------- the plan

# D -> (clusters a group, bytes of shared memory a CTA): the larger of
# the forward's W columns [64, D + 8] and the backward's W rows [D / 16,
# 1032], bf16, plus three staged chunks [128, 72] bf16 (55,296 bytes)
_GRID = {1024: (4, 2 * max(64 * 1032, 64 * 1032) + 55296),
         1280: (5, 2 * max(64 * 1288, 80 * 1032) + 55296)}


@pytest.mark.parametrize("B_", [1, 8, 128, 130, 300])
@pytest.mark.parametrize("D_", [1024, 1280])
def test_grid_plan_counted_by_hand(D_, B_):
    group, smem = _GRID[D_]
    assert smem == {1024: 187392, 1280: 220416}[D_]
    plan = tfr.lstm_cluster_plan(BF, B_, D_)
    assert plan == tfr.ClusterPlan("grid", 128, 16, -(-B_ // 128), 132 // 16,
                                   smem, 16, group)
    assert plan.units * plan.cluster * plan.group == D_
    assert plan.smem <= tfr.SMEM_LIMIT
    # the card's own count, as _cluster_plan passes it
    assert tfr.lstm_cluster_plan(BF, B_, D_, 132, 7).max_clusters == 7


def test_grid_plan_takes_d_768():
    plan = tfr.lstm_cluster_plan(BF, 128, 768)
    assert (plan.route, plan.group, plan.smem) == (
        "grid", 3, 2 * (64 * 776 + 3 * 128 * 72))


# (dtype, B, D, the card's clusters, ng) the grid route refuses
_REFUSED = {
    "bf16-d640": (BF, 128, 640, None, 4),
    "bf16-d1536-smem": (BF, 128, 1536, None, 4),
    "bf16-d1024-3-clusters": (BF, 128, 1024, 3, 4),
    "bf16-d1280-4-clusters": (BF, 128, 1280, 4, 4),
    "fp32-d1024": (F32, 128, 1024, None, 4),
    "fp32-d1280": (F32, 128, 1280, None, 4),
    "gru-bf16-d1024": (BF, 128, 1024, None, 3),
    "gru-bf16-d640": (BF, 512, 640, None, 3),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_grid_plan_refuses(case):
    dtype, B_, D_, mc, ng = _REFUSED[case]
    assert tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc, ng=ng) == \
        tfr.ClusterPlan("streaming", 0, 0, 0, 0, 0)


def test_grid_smem_by_hand():
    # the backward's W rows [96, 1032] are the larger at D 1536
    assert tfr._grid_smem(1536) == 2 * (96 * 1032 + 3 * 128 * 72) == 253440
    assert tfr._grid_smem(1536) > tfr.SMEM_LIMIT
    assert not tfr._grid_shape(BF, 1536, 4)
    assert [D_ for D_ in range(256, 4097, 256)
            if tfr._grid_shape(BF, D_, 4) and D_ > 512] == [768, 1024, 1280]


# the plans the grid route leaves as they were, and fp32 D 512, which its
# fp32 lane takes (4 clusters of 16 CTAs of 8 units; the GRU's too, at its
# own kernels' shared memory): (dtype, B, D, clusters, ng) -> plan
_UNCHANGED = {
    "bf16-b128-d512": ((BF, 128, 512, 7, 4),
                       ("resident", 32, 16, 4, 7, 218112)),
    "bf16-b130-d512": ((BF, 130, 512, 7, 4),
                       ("resident", 32, 16, 5, 7, 218112)),
    "bf16-b16-d64": ((BF, 16, 64, None, 4),
                     ("resident", 16, 2, 1, 66, 32256)),
    "bf16-d512-no-cluster": ((BF, 128, 512, 0, 4),
                             ("streaming", 0, 0, 0, 0, 0)),
    "fp32-d512": ((F32, 128, 512, 7, 4),
                  ("grid", 128, 16, 1, 7, 170496, 8, 4)),
    "gru-bf16-b512-d512": ((BF, 512, 512, 7, 3),
                           ("resident", 48, 16, 11, 7, 221184)),
    "gru-fp32-d512": ((F32, 512, 512, 7, 3),
                      ("grid", 128, 16, 4, 7, 155136, 8, 4)),
}


@pytest.mark.parametrize("case", list(_UNCHANGED))
def test_other_routes_unchanged(case):
    (dtype, B_, D_, mc, ng), want = _UNCHANGED[case]
    assert tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc, ng=ng) == \
        tfr.ClusterPlan(*want)


# ----------------------------------------------- the wrappers' wiring

def _bf16_case(T, B, D, E, seed=3):
    rng = np.random.RandomState(seed)

    def r(*shape, s=0.1):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    lens = torch.from_numpy(rng.randint(0, T + 1, (B, 1)).astype(np.float32))
    c = {"x": r(T, B, 4 * D), "w": r(D, 4 * D), "h0": r(B, D),
         "c0": r(B, D), "dhs": r(T, B, D), "dcs": r(T, B, D),
         "xe": r(T, B, E), "wx": r(E, 4 * D), "b": r(4 * D),
         "gates": r(T, B, 4 * D).sigmoid(), "cs": r(T, B, D)}
    c = {k: v.to(BF) for k, v in c.items()}
    c["lens"] = lens
    return c


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers as on a card, each launch recorded (and counted as
    ``_launch`` counts) in place of the C entry."""
    calls = []

    def launch(name, lane, pointers, ints, dev, entry=None, also=()):
        calls.append({"name": name, "entry": entry or name, "also": also,
                      "ptrs": pointers, "ints": ints})
        for n in (name, *also):
            tk.LAUNCHES[n] += 1

    monkeypatch.setattr(tfr, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(tfr, "_cluster_plan",
                        lambda dtype, B, D, dev, ng=4:
                        tfr.lstm_cluster_plan(dtype, B, D, ng=ng))
    monkeypatch.setattr(tfr, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(tfr, "_launch", launch)
    return calls


def _call(which, c):
    if which == "lstm_fwd":
        return tfr.lstm_fwd(c["x"], c["w"], c["lens"], c["h0"], c["c0"])
    if which == "lstm_bwd":
        return tfr.lstm_bwd_data(c["gates"], c["cs"], c["w"], c["lens"],
                                 c["h0"], c["c0"], c["dhs"], c["dcs"])
    if which == "lstm_proj_fwd":
        return tfr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], c["w"], c["lens"],
                                 c["h0"], c["c0"])
    return tfr.lstm_proj_bwd_data(c["gates"], c["cs"], c["wx"], c["w"],
                                  c["lens"], c["h0"], c["c0"], c["dhs"],
                                  c["dcs"])


# wrapper -> (its entries in launch order, the grid entry's name)
_WIRING = {"lstm_fwd": (["grid_lstm_fwd_x"], "lstm_fwd"),
           "lstm_bwd": (["grid_lstm_bwd"], "lstm_bwd"),
           "lstm_proj_fwd": (["proj_gemm", "grid_lstm_fwd"], "lstm_proj_fwd"),
           "lstm_proj_bwd": (["grid_lstm_bwd", "proj_gemm"], "lstm_proj_bwd")}


@pytest.mark.parametrize("which", list(_WIRING))
@pytest.mark.parametrize("D_", [1024, 1280])
def test_wrappers_launch_the_grid_entries(recorded, which, D_):
    T_, B_, E_ = 3, 5, 128
    c = _bf16_case(T_, B_, D_, E_)
    before = dict(tk.LAUNCHES)
    _call(which, c)
    entries, name = _WIRING[which]
    assert [k["entry"] for k in recorded] == entries
    grid = next(k for k in recorded if k["entry"].startswith("grid"))
    assert grid["name"] == name and grid["also"] == (name + "_grid",)
    assert grid["ints"] == (T_, B_, D_)
    carry, counter = grid["ptrs"][-3 if "bwd" in which else -2], \
        grid["ptrs"][-1]
    assert carry.shape == (2, B_, D_) and carry.dtype == F32
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    if "bwd" in which:
        slots = grid["ptrs"][-2]
        assert slots.shape == (2, D_ // 256, B_, D_) and slots.dtype == F32
        db = grid["ptrs"][8]
        assert (db is None) == (which == "lstm_bwd")
        if db is not None:
            assert db.shape == (4 * D_,) and db.dtype == F32
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    want = {name: 1, name + "_grid": 1}
    if which.startswith("lstm_proj"):
        want["lstm_proj_xg" if "fwd" in which else "lstm_proj_dxe"] = 1
    assert moved == want


@pytest.mark.parametrize("D_,route", [(512, "cluster"), (640, "stream")])
def test_wrappers_keep_the_other_routes(recorded, D_, route):
    """D 512 stays on the one-cluster route, D 640 streams."""
    c = _bf16_case(2, 4, D_, 128)
    for which in _WIRING:
        _call(which, c)
    names = {k["also"][0] for k in recorded if k["also"]}
    assert names == {f"{w}_{route}" for w in _WIRING}


def test_failed_grid_launch_raises_without_a_retry(recorded, monkeypatch):
    """A launch that fails raises out of the wrapper; no other route is
    tried."""
    tried = []

    def fail(name, lane, pointers, ints, dev, entry=None, also=()):
        tried.append(entry)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error 82")

    monkeypatch.setattr(tfr, "_launch", fail)
    c = _bf16_case(2, 4, 1024, 128)
    with pytest.raises(RuntimeError, match="CUDA error 82"):
        _call("lstm_fwd", c)
    with pytest.raises(RuntimeError, match="CUDA error 82"):
        _call("lstm_bwd", c)
    assert tried == ["grid_lstm_fwd_x", "grid_lstm_bwd"]


def test_w_resident_functions_raise_on_a_streaming_d(recorded):
    c = _bf16_case(2, 4, 640, 128)
    xg = torch.zeros((2, 4, 4 * 640))
    with pytest.raises(ValueError, match="streaming route"):
        tfr.lstm_cluster_fwd(xg, c["w"], c["lens"], c["h0"], c["c0"])
    with pytest.raises(ValueError, match="streaming route"):
        tfr.lstm_cluster_bwd(c["gates"], c["cs"], c["w"], c["lens"], c["h0"],
                             c["c0"], c["dhs"], c["dcs"])
    assert not recorded


def test_grid_wrappers_check_dtypes_before_routing():
    c = _bf16_case(2, 4, 1024, 128)
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_fwd(c["x"], c["w"].float(), c["lens"], c["h0"], c["c0"])
    with pytest.raises(TypeError, match="float32"):
        tfr.lstm_cluster_fwd(c["x"], c["w"], c["lens"], c["h0"], c["c0"])


# ----------------------------------------- plain versions vs JAX, D 1024

def _inputs(seed, T=3, B=4, D=1024, E=128):
    rng = np.random.RandomState(seed)
    f = np.float32
    a = dict(x=rng.randn(T, B, 4 * D).astype(f) * 0.5,
             w=rng.randn(D, 4 * D).astype(f) * 0.03,
             h0=rng.randn(B, D).astype(f) * 0.3,
             c0=rng.randn(B, D).astype(f) * 0.3,
             lens=rng.randint(1, T + 1, (B, 1)).astype(f),
             dhs=rng.randn(T, B, D).astype(f),
             dcs=rng.randn(T, B, D).astype(f),
             xe=rng.randn(T, B, E).astype(f) * 0.5,
             wx=rng.randn(E, 4 * D).astype(f) * 0.1,
             b=rng.randn(4 * D).astype(f) * 0.1)
    a["lens"][0], a["lens"][-1] = 0, T
    return a


def _j(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.bfloat16 if a.shape[-1] != 1 else a.dtype)


def _t(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(BF) if a.shape[-1] != 1 else t


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _from_jax(a):
    return torch.from_numpy(np.array(a, np.float32)).to(BF)


@pytest.mark.parametrize("proj", [False, True], ids=["b10", "b14"])
def test_grid_forward_plain_matches_jax_at_d1024(jfr, proj):
    """B10 (x as the first term) and B14 as the route runs it (xg = xe @
    Wx + b for every step in fp32, then the recurrence) against
    ``_lstm_fwd_call`` / ``_lstm_proj_fwd_call``; B10 is the recurrence
    on float(x) bit for bit."""
    a = _inputs(31)
    t = {k: _t(v) for k, v in a.items()}
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    if proj:
        names = ("xe", "wx", "b", "w", "lens", "h0", "c0")
        want = jfr._lstm_proj_fwd_call(*(_j(a[k]) for k in names),
                                       interpret=True)
        got = tfr.lstm_cluster_fwd(tfr.lstm_proj_xg(t["xe"], t["wx"],
                                                    t["b"]), *args)
        assert all(torch.equal(p, q) for p, q in zip(
            got, tfr.lstm_proj_fwd(*(t[k] for k in names))))
    else:
        names = ("x", "w", "lens", "h0", "c0")
        want = jfr._lstm_fwd_call(*(_j(a[k]) for k in names),
                                  interpret=True)
        got = tfr.lstm_fwd(t["x"], *args)
        assert all(torch.equal(p, q) for p, q in zip(
            got, tfr.lstm_cluster_fwd(t["x"].float(), *args)))
    for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
        assert g.dtype == BF, name
        _close(g, w_, BF16_FWD_TOL, what=name)


@pytest.mark.parametrize("proj", [False, True], ids=["b11", "b15"])
def test_grid_backward_plain_matches_jax_at_d1024(jfr, proj):
    """B11's recurrence and B15's (the recurrence with db, then dxe = dx @
    Wx^T) from the same (JAX) saved tensors against ``_lstm_bwd_call`` /
    ``_lstm_proj_bwd_call``; B11's dx, dh0, dc0 are B15's recurrence's
    bit for bit."""
    a = _inputs(32)
    j = {k: _j(v) for k, v in a.items()}
    t = {k: _t(v) for k, v in a.items()}
    if proj:
        jhs, jcs, jg = jfr._lstm_proj_fwd_call(
            j["xe"], j["wx"], j["b"], j["w"], j["lens"], j["h0"], j["c0"],
            interpret=True)
        want = jfr._lstm_proj_bwd_call(
            j["xe"], jg, jhs, jcs, j["wx"], j["w"], j["lens"], j["h0"],
            j["c0"], j["dhs"], j["dcs"], interpret=True)
    else:
        jhs, jcs, jg = jfr._lstm_fwd_call(j["x"], j["w"], j["lens"],
                                          j["h0"], j["c0"], interpret=True)
        want = jfr._lstm_bwd_call(jg, jhs, jcs, j["w"], j["lens"], j["h0"],
                                  j["c0"], j["dhs"], j["dcs"],
                                  interpret=True)
    g, hs, cs = (_from_jax(v) for v in (jg, jhs, jcs))
    bargs = (g, cs, t["w"], t["lens"], t["h0"], t["c0"], t["dhs"], t["dcs"])
    dx, db, dh0, dc0 = tfr.lstm_cluster_bwd(*bargs)
    assert db.dtype == F32
    if proj:
        dwx, dw = tfr.lstm_proj_dw(t["xe"], hs, t["h0"], dx)
        got = (tfr.lstm_proj_dxe(dx, t["wx"]), dwx, db, dw, dh0, dc0)
        names = ("dxe", "dwx", "db", "dw", "dh0", "dc0")
    else:
        b11 = tfr.lstm_bwd_data(*bargs)
        assert all(torch.equal(p, q) for p, q in zip(b11, (dx, dh0, dc0)))
        got = (dx, tfr.lstm_dw(hs, t["h0"], dx), dh0, dc0)
        names = ("dx", "dw", "dh0", "dc0")
    for gv, w_, name in zip(got, want, names):
        if name in ("dw", "dwx", "db"):
            _close(gv, w_, 0.1, rtol=2e-2, what=name)
        else:
            _close(gv, w_, BF16_GRAD_TOL, what=name)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grid route's kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _card_case(dev, T, B, D, E, ragged, seed=41):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(BF)

    if ragged:
        lens = torch.randint(0, T + 1, (B, 1), generator=g,
                             device=dev).float()
        lens[0], lens[-1] = 0.0, float(T)
    else:
        lens = torch.full((B, 1), float(T), device=dev)
    return {"x": r(T, B, 4 * D, s=0.5), "w": r(D, 4 * D, s=0.05),
            "lens": lens, "h0": r(B, D, s=0.3), "c0": r(B, D, s=0.3),
            "dhs": r(T, B, D), "dcs": r(T, B, D), "xe": r(T, B, E, s=0.5),
            "wx": r(E, 4 * D, s=0.05), "b": r(4 * D, s=0.1)}


def _bf16_gate(got, plain, exact):
    """chip_smoke.py's bf16 gate: no further from the fp32 plain result
    than 1.5x the bf16 plain version + 1e-3."""
    for a, p, e in zip(got, plain, exact):
        err = float((a.float() - e.float()).abs().max())
        plain_err = float((p.float() - e.float()).abs().max())
        assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


_NAMES = ("lstm_fwd", "lstm_bwd", "lstm_proj_fwd", "lstm_proj_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 8, 1024, 128, False),
                                   (100, 128, 1024, 128, False),
                                   (30, 130, 1024, 128, True),
                                   (5, 8, 1280, 128, False),
                                   (100, 128, 1280, 1280, False),
                                   (30, 130, 1280, 128, True)],
                         ids=["d1024-b8", "d1024-b128", "d1024-b130-ragged",
                              "d1280-b8", "d1280-b128-e1280",
                              "d1280-b130-ragged"])
def test_grid_kernels_match_plain_on_card(cuda_device, shape):
    """B10, B11's recurrence, B14 and B15's recurrence on the grid route
    against their plain versions at chip_smoke.py's bf16 gate, each
    counted once under its wrapper's and its ``_grid`` name; two launches
    bit-equal; B10 bit-equal to B14's recurrence on float(x), B11's dx,
    dh0, dc0 to B15's recurrence's; a zero-length row keeps h0 and c0 and
    gets no dgates."""
    T_, B_, D_, E_, ragged = shape
    c = _card_case(cuda_device, T_, B_, D_, E_, ragged)
    assert tfr._cluster_plan(BF, B_, D_, cuda_device).route == "grid"
    x, w, lens, h0, c0 = (c[k] for k in ("x", "w", "lens", "h0", "c0"))
    before = dict(tk.LAUNCHES)
    fwd = tfr.lstm_fwd(x, w, lens, h0, c0)
    bargs = (fwd[2], fwd[1], w, lens, h0, c0, c["dhs"], c["dcs"])
    bwd = tfr.lstm_bwd_data(*bargs)
    pf = tfr.lstm_proj_fwd(c["xe"], c["wx"], c["b"], w, lens, h0, c0)
    pbargs = (pf[2], pf[1], c["wx"], w, lens, h0, c0, c["dhs"], c["dcs"])
    pb = tfr.lstm_proj_bwd_data(*pbargs)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    assert moved == dict({n: 1 for n in _NAMES},
                         **{n + "_grid": 1 for n in _NAMES},
                         lstm_proj_xg=1, lstm_proj_dxe=1)

    def f32(args):
        return [a if a is lens else a.float() for a in args]

    fargs = (x, w, lens, h0, c0)
    _bf16_gate(fwd, tfr.lstm_fwd_reference(*fargs),
               tfr.lstm_fwd_reference(*f32(fargs)))
    _bf16_gate(bwd, tfr.lstm_bwd_data_reference(*bargs),
               tfr.lstm_bwd_data_reference(*f32(bargs)))
    pfargs = (c["xe"], c["wx"], c["b"], w, lens, h0, c0)
    _bf16_gate(pf, tfr.lstm_proj_fwd_reference(*pfargs),
               tfr.lstm_proj_fwd_reference(*f32(pfargs)))
    _bf16_gate(pb, tfr.lstm_proj_bwd_data_reference(*pbargs),
               tfr.lstm_proj_bwd_data_reference(*f32(pbargs)))
    assert all(torch.equal(a, b_) for a, b_ in zip(fwd, tfr.lstm_fwd(*fargs)))
    assert all(torch.equal(a, b_)
               for a, b_ in zip(bwd, tfr.lstm_bwd_data(*bargs)))
    assert all(torch.equal(a, b_)
               for a, b_ in zip(pb, tfr.lstm_proj_bwd_data(*pbargs)))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        fwd, tfr.lstm_cluster_fwd(x.float(), w, lens, h0, c0)))
    rec = tfr.lstm_cluster_bwd(*bargs)
    assert all(torch.equal(a, b_)
               for a, b_ in zip(bwd, (rec[0], rec[2], rec[3])))
    if ragged:
        zero = lens[:, 0] == 0
        assert bool((fwd[0][:, zero] == h0[zero]).all())
        assert bool((fwd[1][:, zero] == c0[zero]).all())
        assert not bwd[0][:, zero].any()


@pytest.mark.cuda
def test_grid_rows_do_not_depend_on_b_on_card(cuda_device):
    """A row's outputs are the same bits in a B-8 call as in a B-130
    call: the rows loop inside each step in fixed 128-row tiles."""
    c = _card_case(cuda_device, 20, 130, 1024, 128, True)
    x, w, lens, h0, c0 = (c[k] for k in ("x", "w", "lens", "h0", "c0"))
    big = tfr.lstm_fwd(x, w, lens, h0, c0)
    small = tfr.lstm_fwd(x[:, :8].contiguous(), w, lens[:8].contiguous(),
                         h0[:8].contiguous(), c0[:8].contiguous())
    assert all(torch.equal(a[:, :8], b_) for a, b_ in zip(big, small))
    bb = tfr.lstm_bwd_data(big[2], big[1], w, lens, h0, c0, c["dhs"],
                           c["dcs"])
    bs = tfr.lstm_bwd_data(small[2], small[1], w, lens[:8].contiguous(),
                           h0[:8].contiguous(), c0[:8].contiguous(),
                           c["dhs"][:, :8].contiguous(),
                           c["dcs"][:, :8].contiguous())
    assert torch.equal(bb[0][:, :8], bs[0])
    assert torch.equal(bb[1][:8], bs[1]) and torch.equal(bb[2][:8], bs[2])
