"""The LSTM recurrences' grid route in fp32 (B10/B11/B14/B15 at D 256, 512
and 768: W resident in fp32 across a group of D / 128 clusters of 16 CTAs
of 8 units, the step's product on the tensor cores as 3xTF32).

On the CPU:

- ``lstm_cluster_plan``'s fp32 grid route counted by hand at D 256, 512
  and 768 for B 1, 8, 128, 130 and 300 (units a CTA, clusters a group,
  row tiles, shared memory: the larger of the forward's W columns [32, D
  + 4] and the backward's W rows [D / 16, 516], fp32, plus three staged
  chunks [128, 68] fp32), and the fp32 shapes it refuses (D 1024 and
  1280, D 384 and 640, a card that holds fewer clusters than the group,
  for the GRU's kernels too: ``tests/test_torch_gru_grid_fp32.py`` holds
  the GRU's grid plans);
- ``_cluster_plan``'s cache of the card's counts, keyed by route and
  lane: a bf16 D-512 plan (the resident kernels' count) and an fp32
  D-512 plan (the fp32 grid kernels' count, lane 0) each ask the card;
- the four wrappers' wiring in fp32 with the launch recorded (the device
  kind and the plan patched, as on a card): grid entries with lane 0, no
  carry scratch in the forward, the backward's carries and slots [2, D /
  128, B, D], the passes (``proj_gemm`` lane 0) around B14/B15 and not
  B10/B11, the counts under the wrapper's and its ``_grid`` name; a
  failed launch raises and nothing is retried on another route;
- the passes' plain versions in fp32 against the JAX package's ``xe @ wx
  + b`` and ``dx @ wx^T`` at 1e-5, and the route's decomposition (B14:
  xg for every step, then the recurrence; B15: the recurrence with db,
  then dxe; B10 / B11 as the same recurrences) against the Pallas
  kernels in interpret mode at D 256 (T 3, B 4, E 128, lengths with 0
  and T) at ``tests/test_torch_lstm.py``'s fp32 tolerances.

The kernel-vs-plain cases need a card and skip without one (``cuda``
marker): D 512 at B 8, 128 and a ragged 130, and D 256 and 768, each
output within chip_smoke.py's fp32 gates of the plain version, counted
under the ``_grid`` names, two launches bit-equal, a row of a B-8 call
bit-equal to the same row of a B-130 call, the passes within 1e-5 of
their plain versions, and the C entries refusing lane 0 at a D the
route does not take.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import fused_rnn as tfr

BF, F32 = torch.bfloat16, torch.float32
TOL = 1e-5


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


# --------------------------------------------------------------- the plan

def _smem_by_hand(D):
    w_cols = 32 * (D + 4)              # the forward's [32, D + 4] fp32
    w_rows = D // 16 * (512 + 4)       # the backward's [D / 16, 516] fp32
    return 4 * max(w_cols, w_rows) + 4 * 3 * 128 * 68


# D -> (clusters a group, bytes of shared memory a CTA)
_F32_GRID = {256: (2, 137728), 512: (4, 170496), 768: (6, 203520)}


@pytest.mark.parametrize("B_", [1, 8, 128, 130, 300])
@pytest.mark.parametrize("D_", [256, 512, 768])
def test_fp32_grid_plan_counted_by_hand(D_, B_):
    group, smem = _F32_GRID[D_]
    assert smem == _smem_by_hand(D_) == tfr._grid_smem(D_, F32)
    plan = tfr.lstm_cluster_plan(F32, B_, D_)
    assert plan == tfr.ClusterPlan("grid", 128, 16, -(-B_ // 128), 132 // 16,
                                   smem, 8, group)
    assert plan.units * plan.cluster * plan.group == D_
    assert plan.smem <= tfr.SMEM_LIMIT
    # the card's own count, as _cluster_plan passes it
    assert tfr.lstm_cluster_plan(F32, B_, D_, 132, 7).max_clusters == 7


def test_fp32_grid_d_list():
    assert [D_ for D_ in range(64, 4097, 64)
            if tfr._grid_shape(F32, D_, 4)] == list(tfr.GRID_F32_D) == \
        [256, 512, 768]
    # 16 units a CTA at D 1024: W's columns [64, 1028] fp32 alone exceed
    # the opt-in limit
    assert 4 * 64 * (1024 + 4) > tfr.SMEM_LIMIT


# (B, D, the card's clusters, ng) the fp32 grid route refuses
_REFUSED = {
    "d1024": (128, 1024, None, 4),
    "d1280": (128, 1280, None, 4),
    "d384": (128, 384, None, 4),
    "d640": (128, 640, None, 4),
    "d512-3-clusters": (128, 512, 3, 4),
    "d768-5-clusters": (128, 768, 5, 4),
    "d256-no-cluster": (8, 256, 0, 4),
    "gru-d512": (512, 512, 3, 3),
    "gru-d256": (128, 256, 1, 3),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_fp32_grid_plan_refuses(case):
    B_, D_, mc, ng = _REFUSED[case]
    assert tfr.lstm_cluster_plan(F32, B_, D_, 132, mc, ng=ng) == \
        tfr.ClusterPlan("streaming", 0, 0, 0, 0, 0)


def test_bf16_plans_unchanged_beside_the_fp32_lane():
    """The bf16 lane keeps its routes at the fp32 lane's D."""
    assert tfr.lstm_cluster_plan(BF, 128, 512, 132, 7).route == "resident"
    assert tfr.lstm_cluster_plan(BF, 128, 256).route == "resident"
    assert tfr.lstm_cluster_plan(BF, 128, 768).units == 16


@pytest.fixture
def card_queries(monkeypatch):
    """``_cluster_plan`` as on a card: each occupancy entry recorded
    (name, lane, D), answering 7 clusters."""
    asked = []

    def entry(name):
        def fn(lane, out_ptr, D, *rest):
            asked.append((name, lane, D))
            ctypes.c_int.from_address(out_ptr).value = 7
            return 0
        return fn

    monkeypatch.setattr(tfr, "_max_clusters_of", {})
    monkeypatch.setattr(tfr, "_cuda_entry", entry)
    monkeypatch.setattr(tfr, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(tfr.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return asked


def test_cluster_plan_cache_keys_route_and_lane(card_queries):
    """A bf16 D-512 plan (the resident kernels' count) and then an fp32
    D-512 plan (the fp32 grid kernels', at their own shared memory) each
    ask the card; asking again asks nothing."""
    dev = torch.device("cuda", 0)
    bf = tfr._cluster_plan(BF, 128, 512, dev)
    f32 = tfr._cluster_plan(F32, 128, 512, dev)
    assert card_queries == [("cluster_occupancy", 1, 512),
                            ("grid_occupancy", 0, 512)]
    assert (bf.route, bf.max_clusters) == ("resident", 7)
    assert (f32.route, f32.max_clusters, f32.group) == ("grid", 7, 4)
    tfr._cluster_plan(BF, 130, 512, dev)
    tfr._cluster_plan(F32, 8, 512, dev)
    assert len(card_queries) == 2
    # a bf16 grid plan at D 768 is a third count, the fp32 one a fourth
    tfr._cluster_plan(BF, 128, 768, dev)
    tfr._cluster_plan(F32, 128, 768, dev)
    assert card_queries[2:] == [("grid_occupancy", 1, 768),
                                ("grid_occupancy", 0, 768)]


# ----------------------------------------------- the wrappers' wiring

def _f32_case(T, B, D, E, seed=3):
    rng = np.random.RandomState(seed)

    def r(*shape, s=0.1):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    lens = torch.from_numpy(rng.randint(0, T + 1, (B, 1)).astype(np.float32))
    return {"x": r(T, B, 4 * D), "w": r(D, 4 * D), "h0": r(B, D),
            "c0": r(B, D), "dhs": r(T, B, D), "dcs": r(T, B, D),
            "xe": r(T, B, E), "wx": r(E, 4 * D), "b": r(4 * D),
            "gates": r(T, B, 4 * D).sigmoid(), "cs": r(T, B, D),
            "lens": lens}


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers as on a card, each launch recorded (and counted as
    ``_launch`` counts) in place of the C entry."""
    calls = []

    def launch(name, lane, pointers, ints, dev, entry=None, also=()):
        calls.append({"name": name, "entry": entry or name, "also": also,
                      "lane": lane, "ptrs": pointers, "ints": ints})
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


# wrapper -> its entries in launch order; B10 in fp32 takes B14's entry
# (x is its fp32 first term)
_WIRING = {"lstm_fwd": ["grid_lstm_fwd"],
           "lstm_bwd": ["grid_lstm_bwd"],
           "lstm_proj_fwd": ["proj_gemm", "grid_lstm_fwd"],
           "lstm_proj_bwd": ["grid_lstm_bwd", "proj_gemm"]}


@pytest.mark.parametrize("which", list(_WIRING))
@pytest.mark.parametrize("D_", [256, 512, 768])
def test_fp32_wrappers_launch_the_grid_entries(recorded, which, D_):
    T_, B_, E_ = 3, 5, 128
    c = _f32_case(T_, B_, D_, E_)
    before = dict(tk.LAUNCHES)
    _call(which, c)
    assert [k["entry"] for k in recorded] == _WIRING[which]
    assert all(k["lane"] == 0 for k in recorded)
    grid = next(k for k in recorded if k["entry"].startswith("grid"))
    assert grid["name"] == which and grid["also"] == (which + "_grid",)
    assert grid["ints"] == (T_, B_, D_)
    counter = grid["ptrs"][-1]
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    if "bwd" in which:
        carry, slots = grid["ptrs"][-3], grid["ptrs"][-2]
        assert carry.shape == (2, B_, D_) and carry.dtype == F32
        assert slots.shape == (2, D_ // 128, B_, D_) and slots.dtype == F32
        db = grid["ptrs"][8]
        assert (db is None) == (which == "lstm_bwd")
        if db is not None:
            assert db.shape == (4 * D_,) and db.dtype == F32
    else:
        assert grid["ptrs"][-2] is None   # no carry: hs, cs hold it
        assert grid["ptrs"][0].dtype == F32
    for k in recorded:
        if k["entry"] == "proj_gemm":
            M, K, N, mode = k["ints"]
            assert M == T_ * B_ and mode == (0 if "fwd" in which else 1)
            assert (K, N) == ((E_, 4 * D_) if mode == 0 else (4 * D_, E_))
            assert k["ptrs"][-1].dtype == F32
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    want = {which: 1, which + "_grid": 1}
    if which.startswith("lstm_proj"):
        want["lstm_proj_xg" if "fwd" in which else "lstm_proj_dxe"] = 1
    assert moved == want


@pytest.mark.parametrize("D_", [640, 1024])
def test_fp32_wrappers_stream_elsewhere(recorded, D_):
    """fp32 at a D the grid route does not take streams, lane 0, no
    pass."""
    c = _f32_case(2, 4, D_, 128)
    for which in _WIRING:
        _call(which, c)
    assert {k["also"][0] for k in recorded} == {f"{w}_stream"
                                                for w in _WIRING}
    assert all(k["lane"] == 0 and k["entry"] != "proj_gemm"
               for k in recorded)


def test_fp32_failed_grid_launch_raises_without_a_retry(recorded,
                                                        monkeypatch):
    tried = []

    def fail(name, lane, pointers, ints, dev, entry=None, also=()):
        tried.append((entry, lane))
        raise RuntimeError(f"{name} kernel launch failed: CUDA error 82")

    monkeypatch.setattr(tfr, "_launch", fail)
    c = _f32_case(2, 4, 512, 128)
    for which in ("lstm_fwd", "lstm_bwd", "lstm_proj_fwd"):
        with pytest.raises(RuntimeError, match="CUDA error 82"):
            _call(which, c)
    assert tried == [("grid_lstm_fwd", 0), ("grid_lstm_bwd", 0),
                     ("proj_gemm", 0)]


def test_passes_take_one_dtype(recorded):
    """On the card the passes take tensors of one dtype, bf16 or fp32."""
    c = _f32_case(2, 4, 256, 128)
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_proj_xg(c["xe"], c["wx"].to(BF), c["b"])
    with pytest.raises(TypeError, match="one dtype"):
        tfr.lstm_proj_dxe(c["x"].to(BF), c["wx"])
    assert not recorded


# ----------------------------------------- plain versions vs JAX, fp32

def _inputs(seed, T=3, B=4, D=256, E=128):
    rng = np.random.RandomState(seed)
    f = np.float32
    a = dict(x=rng.randn(T, B, 4 * D).astype(f) * 0.5,
             w=rng.randn(D, 4 * D).astype(f) * 0.05,
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def test_fp32_passes_plain_match_jax(jfr):
    """The passes' plain versions against the JAX package's products in
    fp32 (``xe @ wx + b``, ``dx @ wx^T`` at HIGHEST precision)."""
    import jax
    import jax.numpy as jnp
    a = _inputs(41, T=5, B=6, D=256, E=192)
    hi = jax.lax.Precision.HIGHEST
    want_xg = jnp.einsum("tbe,eg->tbg", a["xe"], a["wx"], precision=hi) \
        + a["b"]
    want_dxe = jnp.einsum("tbg,eg->tbe", a["x"], a["wx"], precision=hi)
    got_xg = tfr.lstm_proj_xg(_t(a["xe"]), _t(a["wx"]), _t(a["b"]))
    got_dxe = tfr.lstm_proj_dxe(_t(a["x"]), _t(a["wx"]))
    assert got_xg.dtype == got_dxe.dtype == F32
    for g, w_, name in ((got_xg, want_xg, "xg"), (got_dxe, want_dxe, "dxe")):
        scale = float(np.abs(np.asarray(w_)).max())
        _close(g, w_, TOL * scale, what=name)


@pytest.mark.parametrize("proj", [False, True], ids=["b10", "b14"])
def test_fp32_grid_forward_plain_matches_jax(jfr, proj):
    """B10 (x as the first term) and B14 as the route runs it (xg = xe @
    Wx + b for every step in fp32, then the recurrence) against
    ``_lstm_fwd_call`` / ``_lstm_proj_fwd_call`` at D 256; B10 is B14's
    recurrence on x bit for bit."""
    import jax.numpy as jnp
    a = _inputs(31)
    t = {k: _t(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    args = (t["w"], t["lens"], t["h0"], t["c0"])
    if proj:
        names = ("xe", "wx", "b", "w", "lens", "h0", "c0")
        want = jfr._lstm_proj_fwd_call(*(j[k] for k in names),
                                       interpret=True)
        got = tfr.lstm_cluster_fwd(tfr.lstm_proj_xg(t["xe"], t["wx"],
                                                    t["b"]), *args)
        assert all(torch.equal(p, q) for p, q in zip(
            got, tfr.lstm_proj_fwd(*(t[k] for k in names))))
    else:
        names = ("x", "w", "lens", "h0", "c0")
        want = jfr._lstm_fwd_call(*(j[k] for k in names), interpret=True)
        got = tfr.lstm_fwd(t["x"], *args)
        assert all(torch.equal(p, q) for p, q in zip(
            got, tfr.lstm_cluster_fwd(t["x"], *args)))
    for g, w_, name in zip(got, want, ("hs", "cs", "gates")):
        assert g.dtype == F32, name
        _close(g, w_, TOL, what=name)


@pytest.mark.parametrize("proj", [False, True], ids=["b11", "b15"])
def test_fp32_grid_backward_plain_matches_jax(jfr, proj):
    """B11's recurrence and B15's (the recurrence with db, then dxe = dx @
    Wx^T) from the same (JAX) saved tensors against ``_lstm_bwd_call`` /
    ``_lstm_proj_bwd_call`` at D 256; B11's dx, dh0, dc0 are B15's
    recurrence's bit for bit."""
    import jax.numpy as jnp
    a = _inputs(32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
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
    g, hs, cs = (torch.from_numpy(np.array(v, np.float32))
                 for v in (jg, jhs, jcs))
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
        _close(gv, w_, TOL, TOL, what=name)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grid route's kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _card_case(dev, T, B, D, E, ragged, seed=43):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s

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


def _abs(a, b):
    return float((a - b).abs().max())


def _rel(a, b):
    """chip_smoke.py's "rel": max abs over max |plain|, floored at 1."""
    return _abs(a, b) / max(1.0, float(b.abs().max()))


_NAMES = ("lstm_fwd", "lstm_bwd", "lstm_proj_fwd", "lstm_proj_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 8, 512, 128, False),
                                   (100, 128, 512, 128, False),
                                   (30, 130, 512, 512, True),
                                   (20, 8, 256, 128, True),
                                   (20, 130, 768, 128, True)],
                         ids=["d512-b8", "d512-b128", "d512-b130-ragged",
                              "d256-b8-ragged", "d768-b130-ragged"])
def test_fp32_grid_kernels_match_plain_on_card(cuda_device, shape):
    """B10, B11's recurrence, B14 and B15's recurrence in fp32 on the grid
    route against their plain versions at chip_smoke.py's fp32 gates
    (forwards 1e-5 absolute, backwards 1e-5 of their largest entry), each
    counted once under its wrapper's and its ``_grid`` name; two launches
    bit-equal; B10 bit-equal to B14's recurrence on x; a zero-length row
    keeps h0 and c0 and gets no dgates."""
    T_, B_, D_, E_, ragged = shape
    c = _card_case(cuda_device, T_, B_, D_, E_, ragged)
    assert tfr._cluster_plan(F32, B_, D_, cuda_device).route == "grid"
    x, w, lens, h0, c0 = (c[k] for k in ("x", "w", "lens", "h0", "c0"))
    before = dict(tk.LAUNCHES)
    fwd = tfr.lstm_fwd(x, w, lens, h0, c0)
    bargs = (fwd[2], fwd[1], w, lens, h0, c0, c["dhs"], c["dcs"])
    bwd = tfr.lstm_bwd_data(*bargs)
    pfargs = (c["xe"], c["wx"], c["b"], w, lens, h0, c0)
    pf = tfr.lstm_proj_fwd(*pfargs)
    pbargs = (pf[2], pf[1], c["wx"], w, lens, h0, c0, c["dhs"], c["dcs"])
    pb = tfr.lstm_proj_bwd_data(*pbargs)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    assert moved == dict({n: 1 for n in _NAMES},
                         **{n + "_grid": 1 for n in _NAMES},
                         lstm_proj_xg=1, lstm_proj_dxe=1)
    for got, plain in ((fwd, tfr.lstm_fwd_reference(x, w, lens, h0, c0)),
                       (pf, tfr.lstm_proj_fwd_reference(*pfargs))):
        for a, p in zip(got, plain):
            assert a.dtype == F32 and _abs(a, p) <= TOL
    for got, plain in ((bwd, tfr.lstm_bwd_data_reference(*bargs)),
                       (pb, tfr.lstm_proj_bwd_data_reference(*pbargs))):
        for a, p in zip(got, plain):
            assert a.dtype == F32 and _rel(a, p) <= TOL
    assert all(torch.equal(a, b_) for a, b_ in zip(fwd, tfr.lstm_fwd(
        x, w, lens, h0, c0)))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        bwd, tfr.lstm_bwd_data(*bargs)))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        pb, tfr.lstm_proj_bwd_data(*pbargs)))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        fwd, tfr.lstm_cluster_fwd(x, w, lens, h0, c0)))
    rec = tfr.lstm_cluster_bwd(*bargs)
    assert all(torch.equal(a, b_)
               for a, b_ in zip(bwd, (rec[0], rec[2], rec[3])))
    if ragged:
        zero = lens[:, 0] == 0
        assert bool((fwd[0][:, zero] == h0[zero]).all())
        assert bool((fwd[1][:, zero] == c0[zero]).all())
        assert not bwd[0][:, zero].any()


@pytest.mark.cuda
def test_fp32_grid_rows_do_not_depend_on_b_on_card(cuda_device):
    """A row's outputs are the same bits in a B-8 call as in a B-130
    call: the rows loop inside each step in fixed 128-row tiles."""
    c = _card_case(cuda_device, 20, 130, 512, 128, True)
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


@pytest.mark.cuda
@pytest.mark.parametrize("TBDE", [(100, 128, 512, 128), (100, 128, 512, 512),
                                  (7, 130, 256, 64)],
                         ids=["layer1", "layer2", "ragged-e64"])
def test_fp32_passes_match_plain_on_card(cuda_device, TBDE):
    """The fp32 passes (3xTF32) within 1e-5 of their largest plain
    entry; two launches bit-equal."""
    T_, B_, D_, E_ = TBDE
    c = _card_case(cuda_device, T_, B_, D_, E_, False)
    xg = tfr.lstm_proj_xg(c["xe"], c["wx"], c["b"])
    dxe = tfr.lstm_proj_dxe(c["x"], c["wx"])
    for got, plain in ((xg, tfr.lstm_proj_xg_reference(c["xe"], c["wx"],
                                                       c["b"])),
                       (dxe, tfr.lstm_proj_dxe_reference(c["x"], c["wx"]))):
        assert got.dtype == F32
        assert _abs(got, plain) <= TOL * float(plain.abs().max())
    assert torch.equal(xg, tfr.lstm_proj_xg(c["xe"], c["wx"], c["b"]))
    assert torch.equal(dxe, tfr.lstm_proj_dxe(c["x"], c["wx"]))


@pytest.mark.cuda
def test_fp32_grid_entries_refuse_other_d_on_card(cuda_device):
    """The C entries take lane 0 only at the plan's D: at D 640 each
    returns an error, which the launch raises."""
    D_, B_, T_ = 640, 8, 2
    c = _card_case(cuda_device, T_, B_, D_, 128, False)
    out = [torch.empty_like(c["h0"]) for _ in range(2)]
    hs = torch.empty((T_, B_, D_), device=cuda_device)
    gates = torch.empty_like(c["x"])
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfr._launch("lstm_fwd", 0, (c["x"], c["w"], c["lens"], c["h0"],
                                    c["c0"], hs, hs.clone(), gates, None,
                                    counter), (T_, B_, D_), cuda_device,
                    entry="grid_lstm_fwd")
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfr._launch("lstm_bwd", 0, (gates, hs, c["w"], c["lens"], c["c0"],
                                    c["dhs"], c["dcs"], gates.clone(), None,
                                    *out, torch.empty((2, B_, D_),
                                                      device=cuda_device),
                                    torch.empty((2, 5, B_, D_),
                                                device=cuda_device),
                                    counter), (T_, B_, D_), cuda_device,
                    entry="grid_lstm_bwd")
