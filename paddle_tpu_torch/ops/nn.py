"""Neural-net structure operators: the port of the JAX package's
``ops/nn.py`` (the reference's conv_op.cc, conv_transpose_op.cc,
pool_op.cc, pool_with_index_op.cc, unpool_op.cc, batch_norm_op.cc,
layer_norm, dropout_op.cc, lrn_op.cc, pad_op.cc, spp_op.cc,
bilinear_interp, selective_fc and sampling_id_op.cc): ``conv2d``,
``depthwise_conv2d``, ``conv2d_transpose``, ``pool2d``, ``batch_norm``,
``layer_norm``, ``dropout``, ``lrn``, ``pad``, ``bilinear_interp``,
``max_pool2d_with_index``, ``unpool``, ``spp``, ``conv3d``,
``conv3d_transpose``, ``pool3d``, ``selective_fc`` and ``sampling_id``.

No TPU kernel lies here: the JAX package computes these with
``lax.conv_general_dilated``, ``reduce_window`` and plain jnp, so the
port uses the PyTorch ops of the same function (cuDNN convolutions and
pooling on the card). Layout is NCHW / OIHW at the API, as in the JAX
package. Where a PyTorch op differs from the JAX formula, the formula
is written out: ``batch_norm`` keeps the JAX op's shifted single-pass
statistics, folded multiply-add and hand-written backward (not
``F.batch_norm``, whose running variance is the unbiased one and whose
momentum runs the other way), and ``lrn`` sums ``alpha * x**2`` over
its window as the JAX op does (not ``F.local_response_norm``, which
scales alpha by 1/n).

The random ops (``dropout``, ``sampling_id``) draw from the Executor's
``torch.Generator``, or from one seeded with a nonzero ``seed``
attribute: the same distribution as the JAX package, another stream.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.framework.registry import register_op
from paddle_tpu_torch.ops.math import _generator

__all__ = ["conv2d", "depthwise_conv2d", "conv2d_transpose", "pool2d",
           "batch_norm", "layer_norm", "dropout", "lrn", "pad",
           "bilinear_interp", "max_pool2d_with_index", "unpool", "spp",
           "conv3d", "conv3d_transpose", "pool3d", "selective_fc",
           "sampling_id"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v), int(v))


def _triple(v):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    if len(v) == 1:
        v = v * 3
    return tuple(int(i) for i in v)


@register_op("conv2d", inputs=["Input", "Filter"], outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1},
             amp_compute=True)
def conv2d(ins, attrs, ctx):
    """Cross-correlation, symmetric zero pads, filter [O, I/groups, kh,
    kw]; the output in the input's dtype (bf16 under AMP: the card's
    cuDNN accumulates bf16 products in fp32)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv2d(x, w, stride=_pair(attrs["strides"]),
                   padding=_pair(attrs["paddings"]),
                   dilation=_pair(attrs["dilations"]),
                   groups=attrs["groups"])
    return {"Output": out.to(x.dtype)}


@register_op("depthwise_conv2d", inputs=["Input", "Filter"],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1},
             amp_compute=True)
def depthwise_conv2d(ins, attrs, ctx):
    return conv2d(ins, attrs, ctx)


@register_op("conv2d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"],
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1]},
             amp_compute=True)
def conv2d_transpose(ins, attrs, ctx):
    """The adjoint of conv2d with filter [C_in, C_out, kh, kw] (the JAX
    op's lhs-dilated conv with the kernel rotated, padded k_eff - 1 - p):
    output (H - 1) * s - 2p + d (k - 1) + 1."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv_transpose2d(x, w,
                             stride=_pair(attrs["strides"]),
                             padding=_pair(attrs["paddings"]),
                             dilation=_pair(attrs["dilations"]))
    return {"Output": out.to(x.dtype)}


def _neg_fill(dtype):
    return (float("-inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def _pool(x, pooling_type, ksize, strides, pads, exclusive, nd):
    """Windowed max / average over the last ``nd`` dims: max over
    windows padded with -inf; the average's sum over zero pads divided by
    the count of in-bounds elements where ``exclusive`` and a pad is
    nonzero, else by the window's size. Floor output sizes."""
    mx = (F.max_pool2d, F.max_pool3d)[nd - 2]
    avg = (F.avg_pool2d, F.avg_pool3d)[nd - 2]
    native = all(2 * p <= k for p, k in zip(pads, ksize))
    if pooling_type == "max":
        if not x.dtype.is_floating_point:       # exact below 2**53
            return _pool(x.double(), "max", ksize, strides, pads, exclusive,
                         nd).to(x.dtype)
        if native:
            return mx(x, ksize, strides, pads)
        xp = F.pad(x, [q for p in reversed(pads) for q in (p, p)],
                   value=_neg_fill(x.dtype))
        return mx(xp, ksize, strides)
    divide_by_count = bool(exclusive and any(pads))
    if native:
        return avg(x, ksize, strides, pads,
                   count_include_pad=not divide_by_count)
    flat = [q for p in reversed(pads) for q in (p, p)]
    size = 1
    for k in ksize:
        size *= k
    summed = avg(F.pad(x, flat), ksize, strides) * size
    if not divide_by_count:
        return summed / size
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                            device=x.device), flat)
    return summed / (avg(ones, ksize, strides) * size)


@register_op("pool2d", inputs=["X"], outputs=["Out"],
             attrs={"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                    "paddings": [0, 0], "global_pooling": False,
                    "exclusive": True})
def pool2d(ins, attrs, ctx):
    x = ins["X"][0]
    if attrs["global_pooling"]:
        ksize = tuple(x.shape[2:4])
        pads, strides = (0, 0), ksize
    else:
        ksize = _pair(attrs["ksize"])
        strides = _pair(attrs["strides"])
        pads = _pair(attrs["paddings"])
    out = _pool(x, attrs["pooling_type"], ksize, strides, pads,
                attrs["exclusive"], 2)
    return {"Out": out.to(x.dtype)}


# --------------------------------------------------------------- batch norm

def _bn_layout(x, data_layout):
    """(reduction axes, per-channel broadcast shape, elements a channel)
    of the JAX op: NCHW 4-D reduces (0, 2, 3), any other input axis 0."""
    if x.dim() == 4 and data_layout == "NCHW":
        return (0, 2, 3), (1, -1, 1, 1), x.numel() // x.shape[1]
    return (0,), (1, -1), x.numel() // x.shape[-1]


def _bn_stats(x, shift, axes, shape, n):
    """Single-pass statistics shifted by the running mean: E[x - s] and
    E[(x - s)^2] in fp32, the variance clamped at 0 (no E[x^2] - E[x]^2
    cancellation when |mean| >> std); returns (mean, biased var)."""
    xs = x.float() - shift.reshape(shape)
    m1 = xs.sum(axes) / n
    var = torch.clamp(xs.square().sum(axes) / n - m1.square(), min=0.0)
    return m1 + shift, var


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode normalize over the batch's statistics, with the JAX
    op's hand-written backward: the forward's residuals are x in its own
    dtype, the mean, 1/sqrt(var + eps) and the scale, and the backward
    recomputes x̂. The statistics are outputs too (the op's SavedMean /
    SavedVariance), differentiable: their gradients, where a consumer
    gives any, add dmean / n + dvar * 2 (x - mean) / n to dx (0 where
    the variance was clamped)."""

    @staticmethod
    def forward(ctx, x, scale, bias, shift, axes, shape, n, eps):
        with torch.no_grad():
            mean, var = _bn_stats(x, shift.reshape(-1).float(), axes, shape,
                                  n)
            inv = torch.rsqrt(var + eps)
            # scale and shift folded into one fp32 multiply-add a channel:
            # x in fp32 (x*k and b nearly cancel when |mean| >> std), the
            # result cast back to x's dtype
            k = scale.reshape(-1).float() * inv
            b = bias.reshape(-1).float() - mean * k
            y = (x.float() * k.reshape(shape) + b.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv, var)
        ctx.axes, ctx.shape, ctx.n = axes, shape, n
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv, var = ctx.saved_tensors
        axes, shape, n = ctx.axes, ctx.shape, ctx.n
        xf = x.float()
        dx = dscale = dbias = None
        if dy is not None:
            dyf = dy.float()
            xhat = (xf - mean.reshape(shape)) * inv.reshape(shape)
            db = dyf.sum(axes)
            ds = (dyf * xhat).sum(axes)
            k = (scale.reshape(-1).float() * inv).reshape(shape)
            dx = k * (dyf - (db.reshape(shape)
                             + xhat * ds.reshape(shape)) / n)
            dscale, dbias = ds.to(scale.dtype), db.to(scale.dtype)
        if dmean is not None or dvar is not None:
            extra = torch.zeros_like(xf)
            if dmean is not None:
                extra = extra + dmean.float().reshape(shape) / n
            if dvar is not None:
                live = (var > 0).float() * dvar.float()
                extra = extra + (live.reshape(shape) * 2.0
                                 * (xf - mean.reshape(shape)) / n)
            dx = extra if dx is None else dx + extra
        if dx is not None:
            dx = dx.to(x.dtype)
        # y is invariant to the shift (it cancels in the mean): no grad
        return dx, dscale, dbias, None, None, None, None, None


@register_op("batch_norm",
             inputs=["X", "Scale", "Bias", "Mean", "Variance"],
             outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"],
             attrs={"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                    "data_layout": "NCHW"})
def batch_norm(ins, attrs, ctx):
    """Training: Y over the batch's statistics (``_BatchNormTrain``),
    the running statistics ``mom * old + (1 - mom) * batch`` with the
    biased variance (MeanOut / VarianceOut are the Mean / Variance
    variables, written back by the Executor; no gradient flows through
    them). ``is_test``: Y over the running statistics, which pass
    through."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps, mom = attrs["epsilon"], attrs["momentum"]
    axes, shape, n = _bn_layout(x, attrs["data_layout"])
    if attrs["is_test"]:
        inv = torch.rsqrt(var.float() + eps)
        k = scale.reshape(-1).float() * inv
        b = bias.reshape(-1).float() - mean.float() * k
        y = (x.float() * k.reshape(shape) + b.reshape(shape)).to(x.dtype)
        return {"Y": y, "MeanOut": mean, "VarianceOut": var,
                "SavedMean": mean, "SavedVariance": var}
    y, saved_mean, saved_var = _BatchNormTrain.apply(
        x, scale, bias, mean, axes, shape, n, eps)
    with torch.no_grad():
        mean_out = mom * mean + (1 - mom) * saved_mean
        var_out = mom * var + (1 - mom) * saved_var
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}


@register_op("layer_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "Mean", "Variance"],
             attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
             optional_inputs=["Scale", "Bias"])
def layer_norm(ins, attrs, ctx):
    x = ins["X"][0]
    ax = tuple(range(attrs["begin_norm_axis"], x.dim()))
    xf = x.float()
    mean = xf.mean(ax, keepdim=True)
    var = (xf - mean).square().mean(ax, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + attrs["epsilon"])
    if ins.get("Scale"):
        y = y * ins["Scale"][0]
    if ins.get("Bias"):
        y = y + ins["Bias"][0]
    return {"Y": y.to(x.dtype), "Mean": mean.squeeze(),
            "Variance": var.squeeze()}


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"],
             needs_rng=True,
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0})
def dropout(ins, attrs, ctx):
    """Upscale-in-train dropout: each element kept with probability
    1 - p (Mask 1) and scaled by 1 / (1 - p); under ``is_test`` or p = 0
    the input passes and Mask is all ones."""
    x = ins["X"][0]
    p = attrs["dropout_prob"]
    if ctx.is_test or p == 0.0:
        return {"Out": x, "Mask": torch.ones_like(x)}
    gen = _generator(ctx, attrs["seed"])
    u = torch.rand(x.shape, generator=gen, device=gen.device)
    mask = (u < 1.0 - p).to(x.dtype)
    return {"Out": x * mask / (1.0 - p), "Mask": mask}


@register_op("lrn", inputs=["X"], outputs=["Out", "MidOut"],
             attrs={"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 1.0})
def lrn(ins, attrs, ctx):
    """Cross-channel local response norm: mid = k + alpha * the sum of
    x**2 over a window of n channels padded (n // 2, n - 1 - n // 2);
    Out = x / mid**beta."""
    x = ins["X"][0]
    n, alpha, beta, k = attrs["n"], attrs["alpha"], attrs["beta"], attrs["k"]
    half = n // 2
    sq = F.pad(x.square(), (0, 0, 0, 0, half, n - 1 - half))
    c = x.shape[1]
    window = sq[:, 0:c]
    for i in range(1, n):
        window = window + sq[:, i:i + c]
    mid = k + alpha * window
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


@register_op("pad", inputs=["X"], outputs=["Out"],
             attrs={"paddings": None, "pad_value": 0.0})
def pad(ins, attrs, ctx):
    """``paddings``: (before, after) for each dim, first dim first."""
    x = ins["X"][0]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.dim())):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, flat, value=attrs["pad_value"])}


@register_op("bilinear_interp", inputs=["X"], outputs=["Out"],
             attrs={"out_h": None, "out_w": None})
def bilinear_interp(ins, attrs, ctx):
    """Half-pixel bilinear resize, antialiased when it shrinks (the JAX
    op's ``jax.image.resize(method="bilinear")``)."""
    x = ins["X"][0]
    return {"Out": F.interpolate(x, size=(attrs["out_h"], attrs["out_w"]),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)}


@register_op("max_pool2d_with_index", inputs=["X"], outputs=["Out", "Mask"],
             attrs={"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
                    "global_pooling": False})
def max_pool2d_with_index(ins, attrs, ctx):
    """Max pool that also gives each window's argmax as a flat index into
    the (unpadded) H*W plane, int32; its gradient scatters into those
    positions (the unpool op, its adjoint)."""
    x = ins["X"][0]
    if attrs["global_pooling"]:
        ksize = tuple(x.shape[2:4])
        pads, strides = (0, 0), ksize
    else:
        ksize = _pair(attrs["ksize"])
        strides = _pair(attrs["strides"])
        pads = _pair(attrs["paddings"])
    w = x.shape[3]
    xp = F.pad(x, (pads[1], pads[1], pads[0], pads[0]),
               value=_neg_fill(x.dtype))
    out, idx = F.max_pool2d(xp, ksize, strides, return_indices=True)
    wp = xp.shape[3]
    idx = (idx // wp - pads[0]) * w + (idx % wp - pads[1])
    return {"Out": out, "Mask": idx.to(torch.int32)}


def _scatter_to_plane(values, idx, x_shape):
    """Add [N, C, ...] values into a zero [N, C, H, W] plane at the flat
    H*W positions ``idx``."""
    n, c, h, w = x_shape
    flat = torch.zeros((n, c, h * w), dtype=values.dtype,
                       device=values.device)
    out = flat.scatter_add(2, idx.reshape(n, c, -1).long(),
                           values.reshape(n, c, -1))
    return out.reshape(n, c, h, w)


@register_op("unpool", inputs=["X", "Indices"], outputs=["Out"],
             attrs={"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
                    "unpooling_type": "max"})
def unpool(ins, attrs, ctx):
    """Scatter pooled values back to their argmax positions (Indices from
    ``max_pool2d_with_index``)."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, ph, pw = x.shape
    ksize, strides = _pair(attrs["ksize"]), _pair(attrs["strides"])
    pads = _pair(attrs["paddings"])
    oh = (ph - 1) * strides[0] - 2 * pads[0] + ksize[0]
    ow = (pw - 1) * strides[1] - 2 * pads[1] + ksize[1]
    return {"Out": _scatter_to_plane(x, idx, (n, c, oh, ow))}


@register_op("spp", inputs=["X"], outputs=["Out"],
             attrs={"pyramid_height": 2, "pooling_type": "max"})
def spp(ins, attrs, ctx):
    """Spatial pyramid pooling: levels of 1x1 .. 2^(h-1) square grids,
    each bin i covering [floor(i H / bins), ceil((i + 1) H / bins)) (the
    adaptive pools' bins), flattened and concatenated."""
    x = ins["X"][0]
    n = x.shape[0]
    pool = (F.adaptive_max_pool2d if attrs["pooling_type"] == "max"
            else F.adaptive_avg_pool2d)
    outs = [pool(x, 2 ** level).reshape(n, -1)
            for level in range(attrs["pyramid_height"])]
    return {"Out": torch.cat(outs, dim=1).to(x.dtype)}


# ----------------------------------------------------------------- 3D family

@register_op("conv3d", inputs=["Input", "Filter"], outputs=["Output"],
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1], "groups": 1},
             amp_compute=True)
def conv3d(ins, attrs, ctx):
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv3d(x, w, stride=_triple(attrs["strides"]),
                   padding=_triple(attrs["paddings"]),
                   dilation=_triple(attrs["dilations"]),
                   groups=attrs["groups"])
    return {"Output": out.to(x.dtype)}


@register_op("conv3d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"],
             attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                    "dilations": [1, 1, 1]},
             amp_compute=True)
def conv3d_transpose(ins, attrs, ctx):
    """Filter [C_in, C_out, D, H, W]; the adjoint of conv3d."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv_transpose3d(x, w,
                             stride=_triple(attrs["strides"]),
                             padding=_triple(attrs["paddings"]),
                             dilation=_triple(attrs["dilations"]))
    return {"Output": out.to(x.dtype)}


@register_op("pool3d", inputs=["X"], outputs=["Out"],
             attrs={"pooling_type": "max", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2], "paddings": [0, 0, 0],
                    "global_pooling": False, "exclusive": True})
def pool3d(ins, attrs, ctx):
    x = ins["X"][0]
    if attrs["global_pooling"]:
        ksize = tuple(x.shape[2:5])
        pads, strides = (0, 0, 0), ksize
    else:
        ksize = _triple(attrs["ksize"])
        strides = _triple(attrs["strides"])
        pads = _triple(attrs["paddings"])
    out = _pool(x, attrs["pooling_type"], ksize, strides, pads,
                attrs["exclusive"], 3)
    return {"Out": out.to(x.dtype)}


@register_op("selective_fc", inputs=["X", "W", "Selection"], outputs=["Out"])
def selective_fc(ins, attrs, ctx):
    """Only the selected output columns of an fc: Out[b, k] = X[b] .
    W[:, Sel[b, k]]."""
    x, w = ins["X"][0], ins["W"][0]
    wcols = w.t()[ins["Selection"][0].long()]           # [B, K, In]
    return {"Out": torch.einsum("bi,bki->bk", x, wcols)}


@register_op("sampling_id", inputs=["X"], outputs=["Out"], needs_rng=True,
             attrs={"seed": 0})
def sampling_id(ins, attrs, ctx):
    """One index a row, drawn with probability proportional to the row
    (+1e-20), int32."""
    x = ins["X"][0]
    gen = _generator(ctx, attrs["seed"])
    ids = torch.multinomial(x.float() + 1e-20, 1, generator=gen)[:, 0]
    return {"Out": ids.to(torch.int32)}
