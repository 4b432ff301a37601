"""The GRU's fp32 recurrences on the grid route (B12 ``gru_fwd`` and B13's
reverse recurrence ``gru_bwd_data`` at D 256, 512 and 768: fp32 W resident
across a group of D / 128 clusters of 16 CTAs of 8 units, the products on
the tensor cores as 3xTF32).

On the CPU:

- ``lstm_cluster_plan(..., ng=3)``'s fp32 grid route counted by hand at D
  256, 512 and 768 for B 1, 8, 128, 130, 300 and 512 (units a CTA,
  clusters a group, row tiles, shared memory: the larger of the
  forward's W rows [3 D / 16, 128 + 4] and the backward's [D / 16, 384 +
  4], fp32, plus three staged chunks [128, 68] fp32), the fp32 shapes
  that stream (D 384, 640 and 1024, a card that holds fewer clusters
  than the group) and the bf16 and LSTM plans unchanged;
- ``_cluster_plan``'s card count keyed by the gate count: the GRU's plan
  asks ``grid_occupancy`` with ng 3 (its own kernels' count) and uses
  that count, not the LSTM's;
- the two wrappers' grid wiring with the launch recorded (the device
  kind and the plan patched, as on a card): the entries, their ints and
  scratch, W passed as it lies (no transposed copy), the counts under
  ``gru_fwd`` / ``gru_bwd`` and their ``_grid`` names; a failed launch
  raises and nothing is retried; mixed dtypes raise before any route;
- the plain versions against the JAX package's ``gru_scan`` forward and
  backward (``jax.vjp``) in interpret mode, fp32, at T 6, B 130, D 256,
  ragged with lengths 0 and T.

On the card (``cuda`` marker, skipped here): the kernels against their
plain versions at chip_smoke.py's gates (hs, gates 1e-5; dx, dh0 1e-4)
at the generation shape (30, 128, 512), the training shape (30, 512,
512) uniform and ragged, and D 256 / 768; two launches bit-equal;
zero-length rows keep h0 and get no gradient; the route counts; a row's
bits the same alone as in a batch of 130; the entries refusing other D
and the bf16 lane.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import fused_rnn as tfr

BF, F32 = torch.bfloat16, torch.float32
FWD_TOL = 1e-5      # chip_smoke.GRU_FWD_TOL
GRAD_TOL = 1e-4     # chip_smoke.GRU_GRAD_TOL
JAX_FWD_TOL = 2e-5  # tests/test_torch_fused_rnn.py's fp32 tolerances
JAX_GRAD_TOL = 2e-4


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


# --------------------------------------------------------------- the plan

def _smem_by_hand(D):
    w_fwd = 3 * (D // 16) * (128 + 4)   # the forward's W rows, fp32
    w_bwd = D // 16 * (384 + 4)         # the backward's W rows, fp32
    return 4 * max(w_fwd, w_bwd) + 4 * 3 * 128 * 68   # three chunks


# D -> (clusters a group, bytes of shared memory a CTA)
_GRU_GRID = {256: (2, 129792), 512: (4, 155136), 768: (6, 180480)}


@pytest.mark.parametrize("B_", [1, 8, 128, 130, 300, 512])
@pytest.mark.parametrize("D_", [256, 512, 768])
def test_fp32_gru_grid_plan_counted_by_hand(D_, B_):
    group, smem = _GRU_GRID[D_]
    assert smem == _smem_by_hand(D_) == tfr._grid_smem(D_, F32, 3)
    plan = tfr.lstm_cluster_plan(F32, B_, D_, ng=3)
    assert plan == tfr.ClusterPlan("grid", 128, 16, -(-B_ // 128),
                                   132 // 16, smem, 8, group)
    assert plan.units * plan.cluster * plan.group == D_
    assert plan.smem <= tfr.SMEM_LIMIT
    # the card's own count, as _cluster_plan passes it
    assert tfr.lstm_cluster_plan(F32, B_, D_, 132, 7, ng=3).max_clusters == 7


def test_gru_grid_smem_by_hand_at_d512():
    """At D 512 the forward's W rows (its cluster's 128 units over the 96
    columns u | r | c~ of 32 units) are [96][132] fp32, 50,688 bytes;
    the backward's (32 units over its cluster's 384 columns) [32][388],
    49,664; the three staged chunks [3][128][68] fp32, 104,448: 155,136,
    within the 232,448 a block may opt in to."""
    assert 4 * 96 * 132 == 50688 and 4 * 32 * 388 == 49664
    assert 4 * 3 * 128 * 68 == 104448
    assert tfr._grid_smem(512, F32, 3) == 50688 + 104448 == 155136
    assert tfr._grid_smem(512, F32, 3) <= tfr.SMEM_LIMIT
    # the LSTM's fp32 lane keeps its own
    assert tfr._grid_smem(512, F32) == 170496


# (B, D, the card's clusters) at which the fp32 GRU streams
_STREAMS = {"d384": (128, 384, None), "d640": (512, 640, None),
            "d1024": (512, 1024, None), "d512-3-clusters": (512, 512, 3),
            "d768-5-clusters": (128, 768, 5), "d256-1-cluster": (8, 256, 1)}


@pytest.mark.parametrize("case", list(_STREAMS))
def test_fp32_gru_streams_elsewhere(case):
    B_, D_, mc = _STREAMS[case]
    assert tfr.lstm_cluster_plan(F32, B_, D_, 132, mc, ng=3) == \
        tfr.ClusterPlan("streaming", 0, 0, 0, 0, 0)


def test_fp32_gru_grid_d_list():
    assert [D_ for D_ in range(64, 4097, 64)
            if tfr._grid_shape(F32, D_, 3)] == list(tfr.GRID_F32_D)


# (dtype, B, D, clusters, ng) -> plan fields: the plans the GRU's fp32
# lane leaves as they were
_UNCHANGED = {
    "gru-bf16-b512-d512": ((BF, 512, 512, 7, 3),
                           ("resident", 48, 16, 11, 7, 221184)),
    "gru-bf16-b128-d256": ((BF, 128, 256, None, 3), ("resident",)),
    "gru-bf16-d768": ((BF, 512, 768, 7, 3), ("streaming",)),
    "gru-bf16-d640": ((BF, 512, 640, 7, 3), ("streaming",)),
    "lstm-fp32-d512": ((F32, 128, 512, 7, 4),
                       ("grid", 128, 16, 1, 7, 170496, 8, 4)),
    "lstm-bf16-d768": ((BF, 128, 768, 7, 4), ("grid", 128, 16, 1, 7)),
}


@pytest.mark.parametrize("case", list(_UNCHANGED))
def test_other_plans_unchanged(case):
    (dtype, B_, D_, mc, ng), want = _UNCHANGED[case]
    plan = tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc, ng=ng)
    assert tuple(plan)[:len(want)] == want


@pytest.fixture
def card_queries(monkeypatch):
    """``_cluster_plan`` as on a card: each occupancy entry recorded
    (name, lane, D, ng), answering ``counts[ng]`` clusters."""
    asked = []
    counts = {4: 7, 3: 5}

    def entry(name):
        def fn(lane, out_ptr, D, *rest):
            ng = rest[0] if name == "grid_occupancy" else rest[1]
            asked.append((name, lane, D, ng))
            ctypes.c_int.from_address(out_ptr).value = counts[ng]
            return 0
        return fn

    monkeypatch.setattr(tfr, "_max_clusters_of", {})
    monkeypatch.setattr(tfr, "_cuda_entry", entry)
    monkeypatch.setattr(tfr, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(tfr.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return asked, counts


def test_gru_plan_uses_its_own_kernels_count(card_queries):
    """The LSTM's and the GRU's fp32 D-512 plans each ask the card with
    their own gate count, and each takes its own answer: the GRU's grid
    kernels' co-resident clusters (5 here), not the LSTM's (7)."""
    asked, counts = card_queries
    dev = torch.device("cuda", 0)
    lstm = tfr._cluster_plan(F32, 128, 512, dev)
    gru = tfr._cluster_plan(F32, 512, 512, dev, ng=3)
    assert asked == [("grid_occupancy", 0, 512, 4),
                     ("grid_occupancy", 0, 512, 3)]
    assert (lstm.route, lstm.max_clusters) == ("grid", 7)
    assert (gru.route, gru.max_clusters, gru.group) == ("grid", 5, 4)
    tfr._cluster_plan(F32, 8, 512, dev, ng=3)     # cached
    assert len(asked) == 2
    # a card holding fewer of the GRU's clusters than its group: the GRU
    # streams at D 768 (6 clusters) while the LSTM's lane keeps the grid
    assert tfr._cluster_plan(F32, 128, 768, dev, ng=3).route == "streaming"
    assert tfr._cluster_plan(F32, 128, 768, dev).route == "grid"
    assert asked[2:] == [("grid_occupancy", 0, 768, 3),
                         ("grid_occupancy", 0, 768, 4)]


# ----------------------------------------------- the wrappers' wiring

def _f32_case(T, B, D, seed=3):
    rng = np.random.RandomState(seed)

    def r(*shape, s=0.1):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    lens = torch.from_numpy(rng.randint(0, T + 1, (B, 1)).astype(np.float32))
    return {"x": r(T, B, 3 * D), "w": r(D, 3 * D), "h0": r(B, D),
            "dhs": r(T, B, D), "gates": r(T, B, 3 * D).sigmoid(),
            "hs": r(T, B, D), "lens": lens}


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers as on a card, each launch recorded (and counted as
    ``_launch`` counts) in place of the C entry; a transposed copy of W
    recorded too."""
    calls = []

    def launch(name, lane, pointers, ints, dev, entry=None, also=()):
        calls.append({"name": name, "entry": entry or name, "also": also,
                      "lane": lane, "ptrs": pointers, "ints": ints})
        for n in (name, *also):
            tk.LAUNCHES[n] += 1

    wt = tfr._wt

    def copy(w):
        calls.append({"entry": "_wt"})
        return wt(w)

    monkeypatch.setattr(tfr, "_device_kind", lambda x: "cuda")
    monkeypatch.setattr(tfr, "_cluster_plan",
                        lambda dtype, B, D, dev, ng=4:
                        tfr.lstm_cluster_plan(dtype, B, D, ng=ng))
    monkeypatch.setattr(tfr, "_n_sm", lambda dev: 132)
    monkeypatch.setattr(tfr, "_launch", launch)
    monkeypatch.setattr(tfr, "_wt", copy)
    return calls


def _moved(before):
    return {n: k - before[n] for n, k in tk.LAUNCHES.items()
            if k != before[n]}


@pytest.mark.parametrize("D_", [256, 512, 768])
def test_gru_fwd_launches_the_grid_entry(recorded, D_):
    T_, B_ = 3, 130
    c = _f32_case(T_, B_, D_)
    before = dict(tk.LAUNCHES)
    hs, gates = tfr.gru_fwd(c["x"], c["w"], c["lens"], c["h0"])
    (k,) = recorded
    assert (k["entry"], k["name"], k["lane"], k["also"]) == \
        ("grid_gru_fwd", "gru_fwd", 0, ("gru_fwd_grid",))
    assert k["ints"] == (T_, B_, D_)
    x, w, lens, h0, k_hs, k_gates, hr, slots, counter = k["ptrs"]
    assert x is c["x"] and w is c["w"] and h0 is c["h0"]
    assert k_hs is hs and k_gates is gates
    assert hs.shape == (T_, B_, D_) and gates.shape == (T_, B_, 3 * D_)
    # h, r h in cluster order, rows padded to whole 128-row tiles
    assert hr.shape == (2, 256, D_) and hr.dtype == F32
    assert slots.shape == (D_ // 128, B_, 3 * D_) and slots.dtype == F32
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    assert _moved(before) == {"gru_fwd": 1, "gru_fwd_grid": 1}


@pytest.mark.parametrize("D_", [256, 512, 768])
def test_gru_bwd_launches_the_grid_entry_with_w_as_it_lies(recorded, D_):
    T_, B_ = 3, 130
    c = _f32_case(T_, B_, D_)
    before = dict(tk.LAUNCHES)
    dx, dh0 = tfr.gru_bwd_data(c["gates"], c["hs"], c["w"], c["lens"],
                               c["h0"], c["dhs"])
    (k,) = recorded                     # no transposed copy of W
    assert (k["entry"], k["name"], k["lane"], k["also"]) == \
        ("grid_gru_bwd", "gru_bwd", 0, ("gru_bwd_grid",))
    assert k["ints"] == (T_, B_, D_)
    gates, hs, w, lens, h0, dhs, k_dx, k_dh0, carry, slots, dg, counter = \
        k["ptrs"]
    assert w is c["w"] and gates is c["gates"] and hs is c["hs"]
    assert k_dx is dx and k_dh0 is dh0 and dx.shape == gates.shape
    assert carry.shape == (2, B_, D_) and carry.dtype == F32
    assert slots.shape == (2, D_ // 128, B_, D_) and slots.dtype == F32
    assert dg.shape == (D_ // 128, 256, 384) and dg.dtype == F32
    assert counter.dtype == torch.int32 and counter.tolist() == [0]
    assert _moved(before) == {"gru_bwd": 1, "gru_bwd_grid": 1}


def test_gru_dw_is_unchanged_by_the_route(recorded):
    c = _f32_case(3, 8, 512)
    tfr.gru_dw(c["gates"], c["hs"], c["h0"], c["gates"])
    assert [k["entry"] for k in recorded] == ["gru_dw"]


@pytest.mark.parametrize("D_", [384, 640, 1024])
def test_fp32_gru_streams_at_other_d(recorded, D_):
    """At a D the grid route does not take, both recurrences stream (the
    reverse over a transposed copy of W)."""
    c = _f32_case(2, 4, D_)
    tfr.gru_fwd(c["x"], c["w"], c["lens"], c["h0"])
    tfr.gru_bwd_data(c["gates"], c["hs"], c["w"], c["lens"], c["h0"],
                     c["dhs"])
    assert [k["entry"] for k in recorded] == ["gru_fwd", "_wt", "gru_bwd"]
    assert [k["also"] for k in recorded if "also" in k] == [
        ("gru_fwd_stream",), ("gru_bwd_stream",)]
    assert recorded[2]["ptrs"][2].shape == (3 * D_, D_)


def test_failed_grid_launch_raises_without_a_retry(recorded, monkeypatch):
    tried = []

    def fail(name, lane, pointers, ints, dev, entry=None, also=()):
        tried.append((entry, lane))
        raise RuntimeError(f"{name} kernel launch failed: CUDA error 82")

    monkeypatch.setattr(tfr, "_launch", fail)
    c = _f32_case(2, 4, 512)
    with pytest.raises(RuntimeError, match="CUDA error 82"):
        tfr.gru_fwd(c["x"], c["w"], c["lens"], c["h0"])
    with pytest.raises(RuntimeError, match="CUDA error 82"):
        tfr.gru_bwd_data(c["gates"], c["hs"], c["w"], c["lens"], c["h0"],
                         c["dhs"])
    assert tried == [("grid_gru_fwd", 0), ("grid_gru_bwd", 0)]


@pytest.mark.parametrize("bad", ["fwd-w", "fwd-h0", "bwd-hs", "bwd-dhs"])
def test_mixed_dtypes_raise_before_any_route(recorded, bad):
    c = _f32_case(2, 4, 512)
    kind, name = bad.split("-")
    c[name] = c[name].to(BF)
    with pytest.raises(TypeError, match="dtype"):
        if kind == "fwd":
            tfr.gru_fwd(c["x"], c["w"], c["lens"], c["h0"])
        else:
            tfr.gru_bwd_data(c["gates"], c["hs"], c["w"], c["lens"],
                             c["h0"], c["dhs"])
    assert not recorded


# ------------------------------------------ plain versions vs JAX, fp32

def _inputs(seed=7, T=6, B=130, D=256):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(T, B, 3 * D).astype(f) * 0.5
    w = rng.randn(D, 3 * D).astype(f) * 0.05
    h0 = rng.randn(B, D).astype(f) * 0.3
    lens = rng.randint(0, T + 1, (B, 1)).astype(f)
    lens[0], lens[-1] = 0, T
    dhs = rng.randn(T, B, D).astype(f)
    return x, w, lens, h0, dhs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0.0, err_msg=what)


def test_plain_versions_match_jax_gru_scan(jfr):
    """``gru_fwd_reference`` against ``gru_scan``'s hs and the plain
    backward (``gru_bwd_data_reference`` and ``gru_dw_reference``)
    against ``jax.vjp`` of ``gru_scan`` (dx, dw, dh0), both in fp32, the
    JAX side in interpret mode, at T 6, B 130, D 256 with lengths 0 and
    T; a zero-length row keeps h0 and gets no dx."""
    import jax
    import jax.numpy as jnp
    x, w, lens, h0, dhs = _inputs()
    jx, jw, jl, jh0 = (jnp.asarray(a) for a in (x, w, lens, h0))
    j_hs, vjp = jax.vjp(lambda a, b, c: jfr.gru_scan(a, b, jl, c,
                                                     interpret=True),
                        jx, jw, jh0)
    j_dx, j_dw, j_dh0 = vjp(jnp.asarray(dhs))
    hs, gates = tfr.gru_fwd_reference(_t(x), _t(w), _t(lens), _t(h0))
    assert hs.dtype == gates.dtype == F32
    _close(hs, j_hs, JAX_FWD_TOL, "hs")
    dx, dh0 = tfr.gru_bwd_data_reference(gates, hs, _t(w), _t(lens), _t(h0),
                                         _t(dhs))
    dw = tfr.gru_dw_reference(gates, hs, _t(h0), dx)
    for got, want, name in ((dx, j_dx, "dx"), (dw, j_dw, "dw"),
                            (dh0, j_dh0, "dh0")):
        _close(got, want, JAX_GRAD_TOL, name)
    assert bool((hs[:, 0] == _t(h0)[0]).all())
    assert not dx[:, 0].any()


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grid route's kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _card(dev, T, B, D, ragged, seed=5):
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
    return (r(T, B, 3 * D, s=0.5), r(D, 3 * D, s=0.05), lens,
            r(B, D, s=0.3), r(T, B, D))


def _err(a, b):
    return float((a - b).abs().max())


# (T, B, D, ragged): generation, training (uniform and ragged), D 256 and
# 768 at a ragged two-tile batch
_CARD_SHAPES = {"beam": (30, 128, 512, False),
                "train": (30, 512, 512, False),
                "train-ragged": (30, 512, 512, True),
                "d256": (12, 130, 256, True),
                "d768": (12, 300, 768, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CARD_SHAPES))
def test_grid_kernels_match_plain_on_card(cuda_device, case):
    """The grid forward and reverse recurrence, each counted once under
    its wrapper's and its ``_grid`` name, against their plain versions at
    chip_smoke.py's gates; two launches of each bit-equal; zero-length
    rows keep h0 and get no gradient."""
    T_, B_, D_, ragged = _CARD_SHAPES[case]
    x, w, lens, h0, dhs = _card(cuda_device, T_, B_, D_, ragged)
    assert tfr._cluster_plan(F32, B_, D_, cuda_device, ng=3).route == "grid"
    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES)
    hs, gates = tfr.gru_fwd(x, w, lens, h0)
    dx, dh0 = tfr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    torch.cuda.synchronize()
    assert _moved(before) == {"gru_fwd": 1, "gru_fwd_grid": 1,
                              "gru_bwd": 1, "gru_bwd_grid": 1}
    r_hs, r_gates = tfr.gru_fwd_reference(x, w, lens, h0)
    r_dx, r_dh0 = tfr.gru_bwd_data_reference(gates, hs, w, lens, h0, dhs)
    for name, got, plain, tol in (("hs", hs, r_hs, FWD_TOL),
                                  ("gates", gates, r_gates, FWD_TOL),
                                  ("dx", dx, r_dx, GRAD_TOL),
                                  ("dh0", dh0, r_dh0, GRAD_TOL)):
        assert got.dtype == F32
        assert _err(got, plain) <= tol, (name, _err(got, plain))
    again = tfr.gru_fwd(x, w, lens, h0)
    assert torch.equal(again[0], hs) and torch.equal(again[1], gates)
    again = tfr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dh0)
    if ragged:
        zero = lens[:, 0] == 0
        assert bool(zero.any())
        assert bool((hs[:, zero] == h0[zero]).all())
        assert not dx[:, zero].any()


@pytest.mark.cuda
def test_a_rows_bits_do_not_depend_on_the_batch_on_card(cuda_device):
    """Row 77 of a B-130 call and the same row as a call of its own give
    the same bits, forward and reverse."""
    x, w, lens, h0, dhs = _card(cuda_device, 20, 130, 512, True)
    big = tfr.gru_fwd(x, w, lens, h0)
    big_b = tfr.gru_bwd_data(big[1], big[0], w, lens, h0, dhs)
    row = slice(77, 78)
    sub = [t[:, row].contiguous() for t in (x, big[1], big[0], dhs)]
    l1, h1 = lens[row].clone(), h0[row].clone()   # fresh, aligned
    small = tfr.gru_fwd(sub[0], w, l1, h1)
    small_b = tfr.gru_bwd_data(sub[1], sub[2], w, l1, h1, sub[3])
    assert torch.equal(small[0], big[0][:, row])
    assert torch.equal(small[1], big[1][:, row])
    assert torch.equal(small_b[0], big_b[0][:, row])
    assert torch.equal(small_b[1], big_b[1][row])


@pytest.mark.cuda
def test_grid_entries_refuse_other_d_and_the_bf16_lane_on_card(cuda_device):
    """The C entries take lane 0 at the plan's D only: D 640 and the bf16
    lane return an error, which the launch raises."""
    dev = cuda_device
    for D_, lane, dtype in ((640, 0, F32), (512, 1, BF)):
        x, w, lens, h0, dhs = (t.to(dtype) if t.shape[-1] != 1 else t
                               for t in _card(dev, 2, 8, D_, False))
        hs = torch.empty((2, 8, D_), device=dev, dtype=dtype)
        f32 = dict(device=dev, dtype=F32)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tfr._launch("gru_fwd", lane, (x, w, lens, h0, hs,
                                          torch.empty_like(x),
                                          torch.empty((2, 128, D_), **f32),
                                          torch.empty((5, 8, 3 * D_), **f32),
                                          counter), (2, 8, D_), dev,
                        entry="grid_gru_fwd")
        with pytest.raises(RuntimeError, match="CUDA error"):
            tfr._launch("gru_bwd", lane, (x, hs, w, lens, h0, dhs,
                                          torch.empty_like(x),
                                          torch.empty_like(h0),
                                          torch.empty((2, 8, D_), **f32),
                                          torch.empty((2, 5, 8, D_), **f32),
                                          torch.empty((5, 128, 384), **f32),
                                          counter), (2, 8, D_), dev,
                        entry="grid_gru_bwd")
