"""The GRU's bf16 resident route (B12 ``gru_fwd`` and B13's reverse
recurrence ``gru_bwd_data`` with W split over one thread-block cluster's
shared memory).

On the CPU:

- the route and tile of the generalised plan ``lstm_cluster_plan(...,
  ng=3)``: fp32 at D 512 takes the grid route (16-CTA clusters;
  ``tests/test_torch_gru_grid_fp32.py`` holds it); bf16 at D 128 / 384 /
  512 is resident with 4 /
  12 / 16 CTAs a cluster; D 640, a card that holds no cluster and a
  shared-memory overflow stream; the tile is the one with the fewest
  waves (48 rows at the seq2seq batch of 512);
- the CTAs' shared memory (``_rec_smem`` with ng 3) as worked out by hand
  at D 512, and the LSTM's tile rule unchanged by the generalisation;
- the plain versions ``gru_fwd_reference`` / ``gru_bwd_data_reference``
  (what the CPU path runs, and what the kernels are held against on the
  card) against JAX ``_gru_fwd_call`` / ``_gru_bwd_call`` in interpret
  mode at a resident width (T 6, B 48, D 256, bf16, lengths with 0 and
  T): hs and gates atol 2e-2, dx and dh0 atol 5e-2 (the bf16 tolerances
  of ``test_torch_fused_rnn.py``: one bf16 ulp of the same fp32 carries).

On the card (``cuda`` marker, skipped here): the resident kernels against
their plain versions at chip_smoke.py's bf16 gate, two launches and a
row's bits across batch sizes, zero-length rows, the route counts and
the raises on mixed dtypes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import fused_rnn as tfr

BF = torch.bfloat16
BF16_FWD_TOL = 2e-2
BF16_GRAD_TOL = 5e-2


@pytest.fixture(scope="module")
def jfr():
    pytest.importorskip("jax")
    from paddle_tpu.kernels import fused_rnn
    return fused_rnn


def _inputs(seed=1, B=48, T=6, D=256, ragged=True):
    """x, w, h0, lens (ragged with 0 and T present, or all T), dhs."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 3 * D).astype(np.float32) * 0.5
    w = rng.randn(D, 3 * D).astype(np.float32) * 0.05
    h0 = rng.randn(B, D).astype(np.float32) * 0.3
    if ragged:
        lens = rng.randint(0, T + 1, (B, 1)).astype(np.float32)
        lens[0], lens[1] = 0, T
    else:
        lens = np.full((B, 1), T, np.float32)
    dhs = rng.randn(T, B, D).astype(np.float32)
    return x, w, lens, h0, dhs


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(
        dtype if a.shape[-1] != 1 else torch.float32) for a in arrays]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------- the plan

# case -> (dtype, B, D, max_clusters, smem_limit, (route, cluster))
_ROUTES = {
    "fp32-d512": (torch.float32, 512, 512, 7, None, ("grid", 16)),
    "bf16-d128": (BF, 512, 128, None, None, ("resident", 4)),
    "bf16-d384": (BF, 512, 384, None, None, ("resident", 12)),
    "bf16-d512": (BF, 512, 512, 7, None, ("resident", 16)),
    "bf16-d640": (BF, 512, 640, None, None, ("streaming", 0)),
    "bf16-no-cluster": (BF, 512, 512, 0, None, ("streaming", 0)),
    "bf16-smem-overflow": (BF, 512, 512, 7, 140_000, ("streaming", 0)),
}


@pytest.mark.parametrize("case", list(_ROUTES))
def test_gru_plan_route(case, monkeypatch):
    """Resident: bf16, D a multiple of 32 with at most 16 CTAs a cluster,
    the 16-row tile's CTAs within SMEM_LIMIT (the GRU's forward takes
    140,288 bytes there at D 512), and a card that holds a cluster."""
    dtype, B_, D_, mc, limit, (route, nc) = _ROUTES[case]
    if limit is not None:
        monkeypatch.setattr(tfr, "SMEM_LIMIT", limit)
    plan = tfr.lstm_cluster_plan(dtype, B_, D_, 132, mc, ng=3)
    assert (plan.route, plan.cluster) == (route, nc)
    if route == "streaming":
        assert plan == tfr.ClusterPlan("streaming", 0, 0, 0, 0, 0)
        return
    assert plan.max_clusters == (mc if mc is not None else 132 // nc)
    assert plan.smem <= tfr.SMEM_LIMIT


# (B, D, max_clusters) -> (bb, clusters, waves): the H100 holds 7 of the
# 16-CTA clusters at once
_TILES = {
    "seq2seq-train": (512, 512, 7, (48, 11, 2)),
    "beam": (128, 512, 7, (32, 4, 1)),
    "b48": (48, 512, 7, (16, 3, 1)),
    "b130": (130, 512, 7, (32, 5, 1)),
    "b1": (1, 512, 7, (16, 1, 1)),
    "b2000": (2000, 512, 7, (48, 42, 6)),
    "d128-b512": (512, 128, None, (16, 32, 1)),
}


@pytest.mark.parametrize("case", list(_TILES))
def test_gru_plan_takes_the_tile_with_the_fewest_waves(case):
    """Of the 16-, 32- and 48-row tiles whose shared memory fits, the one
    with the fewest waves of clusters, the smaller of two with as many;
    at the seq2seq batch (B 512, D 512) that is 48 rows: 11 clusters in
    2 waves, where 32 rows take 16 in 3."""
    B_, D_, mc, (bb, tiles, waves) = _TILES[case]
    plan = tfr.lstm_cluster_plan(BF, B_, D_, 132, mc, ng=3)
    assert (plan.route, plan.bb, plan.tiles) == ("resident", bb, tiles)
    assert -(-plan.tiles // plan.max_clusters) == waves
    for other in tfr.REC_TILES[3]:
        fits = max(tfr._rec_smem("fwd", other, D_, 3),
                   tfr._rec_smem("bwd", other, D_, 3)) <= tfr.SMEM_LIMIT
        if fits:
            assert -(-(-(-B_ // other)) // plan.max_clusters) >= waves


def test_gru_rec_smem_by_hand_at_d512():
    """rc::fwd_smem / bwd_smem with 3 gates at D 512 (rows of W's slice
    and of the buffers padded to D + 8 = 520 bf16):
    forward: W slice 96 x 520 x 2 = 99,840; h and r * h buffers 2 x bb x
    520 x 2; staged slice bb x 32 x 2; K-half partials 4 x bb/16 x 3 x 32
    x 4 fp32 x 4 bytes;
    backward: W slice 99,840; dgates tile bb x 104 x 2; slots 16 x bb x
    32 x 4."""
    assert tfr._rec_smem("fwd", 16, 512, 3) == 99840 + 33280 + 1024 + 6144
    assert tfr._rec_smem("fwd", 32, 512, 3) == 99840 + 66560 + 2048 + 12288
    assert tfr._rec_smem("fwd", 48, 512, 3) == 99840 + 99840 + 3072 + 18432
    assert tfr._rec_smem("fwd", 48, 512, 3) == 221184
    assert tfr._rec_smem("bwd", 16, 512, 3) == 99840 + 3328 + 32768
    assert tfr._rec_smem("bwd", 32, 512, 3) == 99840 + 6656 + 65536
    assert tfr._rec_smem("bwd", 48, 512, 3) == 208128
    # a 64-row tile would not fit beside W's slice
    assert tfr._rec_smem("fwd", 64, 512, 3) > tfr.SMEM_LIMIT


def test_lstm_tile_rule_is_unchanged_by_the_gate_count():
    """The generalised rule (the fewest waves, then the smaller tile)
    gives the LSTM the tile of its own rule: 16 rows while ceil(B / 16)
    clusters fit at once, else 32, at every B up to 600 and every card
    count up to 20."""
    for mc in range(1, 21):
        for B_ in range(1, 601):
            plan = tfr.lstm_cluster_plan(BF, B_, 512, 132, mc)
            assert plan.bb == (16 if -(-B_ // 16) <= mc else 32), (mc, B_)


# ------------------------------------- the plain versions against JAX

@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_plain_versions_match_jax_at_a_resident_width(jfr, which):
    """bf16 at T 6, B 48, D 256 (a resident shape: 8 CTAs a cluster),
    ragged lengths with 0 and T: the forward's hs and gates, and the
    reverse recurrence's dx and dh0 from JAX's own saved gates and hs."""
    import jax.numpy as jnp
    x, w, lens, h0, dhs = _inputs()
    assert tfr.lstm_cluster_plan(BF, 48, 256, ng=3).route == "resident"
    jx, jw, jh0, jd = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, h0, dhs))
    jl = jnp.asarray(lens)
    j_hs, j_gates = jfr._gru_fwd_call(jx, jw, jl, jh0, interpret=True)
    tx, tw, tl, th0, td = _t(x, w, lens, h0, dhs, dtype=BF)
    if which == "fwd":
        hs, gates = tfr.gru_fwd_reference(tx, tw, tl, th0)
        assert hs.dtype == gates.dtype == BF
        np.testing.assert_allclose(_np(hs), _np(j_hs), atol=BF16_FWD_TOL)
        np.testing.assert_allclose(_np(gates), _np(j_gates),
                                   atol=BF16_FWD_TOL)
        return
    j_dx, _j_dw, j_dh0 = jfr._gru_bwd_call(j_gates, j_hs, jw, jl, jh0, jd,
                                           interpret=True)
    gates, hs = (torch.from_numpy(np.array(a, np.float32)).to(BF)
                 for a in (j_gates, j_hs))
    dx, dh0 = tfr.gru_bwd_data_reference(gates, hs, tw, tl, th0, td)
    assert dx.dtype == dh0.dtype == BF
    np.testing.assert_allclose(_np(dx), _np(j_dx), atol=BF16_GRAD_TOL)
    np.testing.assert_allclose(_np(dh0), _np(j_dh0), atol=BF16_GRAD_TOL)
    zero = lens[:, 0] == 0
    assert not dx[:, torch.from_numpy(zero)].any()


def test_mixed_dtypes_raise_before_any_route():
    """A forward with one fp32 tensor among bf16 ones raises before the
    plan of either dtype is asked (the card test covers the reverse's
    dhs and hs)."""
    x, w, lens, h0, _dhs = _t(*_inputs(B=4, T=3, D=64), dtype=BF)
    for bad in ("w", "h0"):
        args = {"x": x, "w": w, "h0": h0}
        args[bad] = args[bad].float()
        with pytest.raises(TypeError, match="one dtype"):
            tfr.gru_fwd(args["x"], args["w"], lens, args["h0"])


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GRU kernels have no CPU mode")
    return torch.device("cuda")


def _card(dev, T_, B_, D_, ragged, seed=5):
    x, w, lens, h0, dhs = (t.to(dev) for t in _t(*_inputs(
        seed=seed, B=B_, T=T_, D=D_, ragged=ragged)))
    return x, w, lens, h0, dhs


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# (T, B, D, ragged): the seq2seq training batch, uniform and ragged; the
# generation batch; a small and an odd width with ragged batches
_CARD_SHAPES = {"train": (30, 512, 512, False),
                "train-ragged": (30, 512, 512, True),
                "beam": (30, 128, 512, False),
                "d128": (7, 40, 128, True),
                "d384": (5, 130, 384, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CARD_SHAPES))
def test_resident_kernels_match_plain_on_card(cuda_device, case):
    """The resident forward and reverse recurrence (each counted once
    under its wrapper's and its route's name) against the fp32 plain
    result, no further than 1.5x the bf16 plain version's error + 1e-3
    (chip_smoke.py's gate); two launches of each bit-equal; zero-length
    rows keep h0 and get no gradient."""
    T_, B_, D_, ragged = _CARD_SHAPES[case]
    x, w, lens, h0, dhs = _card(cuda_device, T_, B_, D_, ragged)
    xs, ws, h0s, dhss = (t.to(BF) for t in (x, w, h0, dhs))
    plan = tfr._cluster_plan(BF, B_, D_, cuda_device, ng=3)
    assert plan.route == "resident"
    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES)
    hs, gates = tfr.gru_fwd(xs, ws, lens, h0s)
    dx, dh0 = tfr.gru_bwd_data(gates, hs, ws, lens, h0s, dhss)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    assert moved == {"gru_fwd": 1, "gru_fwd_cluster": 1, "gru_bwd": 1,
                     "gru_bwd_cluster": 1}
    again = tfr.gru_fwd(xs, ws, lens, h0s)
    assert torch.equal(again[0], hs) and torch.equal(again[1], gates)
    again = tfr.gru_bwd_data(gates, hs, ws, lens, h0s, dhss)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dh0)
    r_hs, r_gates = tfr.gru_fwd_reference(xs, ws, lens, h0s)
    r_dx, r_dh0 = tfr.gru_bwd_data_reference(gates, hs, ws, lens, h0s, dhss)
    f_hs, f_gates = tfr.gru_fwd_reference(x, w, lens, h0)
    f_dx, f_dh0 = tfr.gru_bwd_data_reference(gates.float(), hs.float(), w,
                                             lens, h0, dhss.float())
    for name, got, plain, exact in (("hs", hs, r_hs, f_hs),
                                    ("gates", gates, r_gates, f_gates),
                                    ("dx", dx, r_dx, f_dx),
                                    ("dh0", dh0, r_dh0, f_dh0)):
        assert got.dtype == BF
        err, plain_err = _max_err(got, exact), _max_err(plain, exact)
        assert err <= 1.5 * plain_err + 1e-3, (name, err, plain_err)
    zero = lens[:, 0] == 0
    if ragged:
        assert bool(zero.any())
        assert bool((hs[:, zero] == h0s[zero]).all())
        assert not dx[:, zero].any()


@pytest.mark.cuda
def test_a_rows_bits_do_not_depend_on_the_batch_on_card(cuda_device):
    """Rows 96..143 of a B-512 call (48-row tiles, 11 clusters) and the
    same rows as a B-48 call of their own (16-row tiles) give the same
    bits: forward and reverse."""
    x, w, lens, h0, dhs = (t.to(BF) if t.shape[-1] != 1 else t
                           for t in _card(cuda_device, 30, 512, 512, True))
    rows = slice(96, 144)
    big = tfr.gru_fwd(x, w, lens, h0)
    big_b = tfr.gru_bwd_data(big[1], big[0], w, lens, h0, dhs)
    assert tfr._cluster_plan(BF, 512, 512, cuda_device, ng=3).bb != \
        tfr._cluster_plan(BF, 48, 512, cuda_device, ng=3).bb
    sub = [t[:, rows].contiguous() for t in (x, big[1], big[0], dhs)]
    l48, h48 = lens[rows].contiguous(), h0[rows].contiguous()
    small = tfr.gru_fwd(sub[0], w, l48, h48)
    small_b = tfr.gru_bwd_data(sub[1], sub[2], w, l48, h48, sub[3])
    assert torch.equal(small[0], big[0][:, rows])
    assert torch.equal(small[1], big[1][:, rows])
    assert torch.equal(small_b[0], big_b[0][:, rows])
    assert torch.equal(small_b[1], big_b[1][rows])


# (dtype, T, B, D) -> route: the plan's, counted under its own name
_COUNTED = {"bf16-d512": (BF, 5, 64, 512, "cluster"),
            "fp32-d512": (torch.float32, 5, 64, 512, "grid"),
            "bf16-d640": (BF, 3, 8, 640, "stream")}
_PLANNED = {"cluster": "resident", "grid": "grid", "stream": "streaming"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_COUNTED))
def test_route_counts_follow_the_plan_on_card(cuda_device, case):
    dtype, T_, B_, D_, route = _COUNTED[case]
    x, w, lens, h0, dhs = (t.to(dtype) if t.shape[-1] != 1 else t
                           for t in _card(cuda_device, T_, B_, D_, False))
    plan = tfr._cluster_plan(dtype, B_, D_, cuda_device, ng=3)
    assert plan.route == _PLANNED[route]
    torch.cuda.synchronize()
    before = dict(tk.LAUNCHES)
    hs, gates = tfr.gru_fwd(x, w, lens, h0)
    tfr.gru_bwd_data(gates, hs, w, lens, h0, dhs)
    torch.cuda.synchronize()
    moved = {n: k - before[n] for n, k in tk.LAUNCHES.items()
             if k != before[n]}
    assert moved == {"gru_fwd": 1, f"gru_fwd_{route}": 1, "gru_bwd": 1,
                     f"gru_bwd_{route}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["fwd-w", "fwd-h0", "bwd-dhs", "bwd-hs"])
def test_mixed_dtypes_raise_on_card(cuda_device, bad):
    x, w, lens, h0, dhs = (t.to(BF) if t.shape[-1] != 1 else t
                           for t in _card(cuda_device, 3, 16, 128, False))
    hs, gates = tfr.gru_fwd(x, w, lens, h0)
    kind, name = bad.split("-")
    t = {"x": x, "w": w, "h0": h0, "dhs": dhs, "hs": hs}
    t[name] = t[name].float()
    with pytest.raises(TypeError, match="dtype"):
        if kind == "fwd":
            tfr.gru_fwd(t["x"], t["w"], lens, t["h0"])
        else:
            tfr.gru_bwd_data(gates, t["hs"], w, lens, h0, t["dhs"])
