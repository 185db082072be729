"""Deep-network ops: the conv2d family, pooling, bias, relu, softmax, and
the fused LSTM and batch norm.

Port of systemml_tpu/ops/dnn.py, with the same function names and
signatures over DML's flattened boundary form: an [N, C, H, W] tensor is
an (N, C*H*W) matrix, channel-major; a filter [F, C, Hf, Wf] is
(F, C*Hf*Wf). The JAX package leaves conv, pooling, LSTM and batch norm
to XLA (lax.conv_general_dilated, lax.reduce_window, lax.scan); here
they are cuDNN through torch.nn.functional and aten's pooling kernels on
the card, and torch's CPU kernels in the tests. No op moves a CUDA tensor
to the CPU, and no arm gives way to another after a failure: the arm is
chosen by shape and settings before any launch, and counted.

Layout (`device_layout`): "NHWC" computes convs and pools on channels-
last tensors. With the layout pass's `nhwc_in` / `nhwc_out` flags
(hops/layout.py) an op takes or gives a raw (N, H, W, C) tensor, so the
boundary transposes cancel between chained ops; each transpose that is
materialized is counted with its bytes (`_count_transpose`). "auto" is
NCHW on the CPU, as in the JAX package, and on the card the layout that
measured faster for cuDNN at fp32 with TF32 off (CUDA_AUTO_LAYOUT;
PERF.md §6 gives the times).

Algorithm (`conv_algo`): "conv" (cuDNN, F.conv2d) or "im2col" (unfold
and one matmul), cached per geometry, so that a layer's backward ops
differentiate the arm its forward took: "conv" through aten's
convolution_backward, "im2col" through the adjoint of its unfold and
matmul (fold). On the CPU "auto" keeps the JAX package's rule, so that
the parity tests pick the same arms; on the card it follows a rule
measured there (CUDA_AUTO_ALGO).

Precision: under the "bfloat16" mixed policy the conv family's and the
LSTM's products take operands rounded to bf16 and compute in fp32
(utils/config.bf16_operands); outputs and storage stay fp32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from systemml_tpu_torch.utils.config import bf16_operands, get_config

# what "auto" takes on the card: cuDNN in NCHW was faster than im2col and
# than channels-last, in the forward and both gradients, at each of
# ResNet-18's and LeNet's geometries (chip_smoke.py `[conv-rule]`,
# PERF.md §6)
CUDA_AUTO_LAYOUT = "NCHW"
CUDA_AUTO_ALGO = "conv"


def out_dim(dim: int, k: int, stride: int, pad: int) -> int:
    return (dim + 2 * pad - k) // stride + 1


def _nchw(x, n, c, h, w):
    return x.reshape(int(n), int(c), int(h), int(w))


# --------------------------------------------------------------------------
# counters: each op run adds to the ambient Statistics (a loop region's
# capture scales them by the body's executions)
# --------------------------------------------------------------------------

def _stats():
    from systemml_tpu_torch.utils import stats as stats_mod

    return stats_mod.current()


def _count_transpose(t: torch.Tensor, site: str) -> None:
    """Account one materialized layout transpose and its bytes."""
    st = _stats()
    nbytes = t.numel() * t.element_size()
    if st is not None:
        st.count_estim("dnn_transpose_bytes", nbytes)
        st.count_estim("dnn_transposes")
    from systemml_tpu_torch.obs import trace as obs

    obs.instant("layout_transpose", obs.CAT_COMPILE, site=site,
                bytes=nbytes)


def _count_layer(kind: str, detail: str) -> None:
    st = _stats()
    if st is not None:
        st.count_estim(f"dnn_{kind}[{detail}]")


# --------------------------------------------------------------------------
# layout plumbing
# --------------------------------------------------------------------------

def device_layout(device=None) -> str:
    """The conv/pool compute layout for `device` (default: the configured
    device)."""
    cfg = get_config().conv_layout
    if cfg == "auto":
        dev = torch.device(get_config().device if device is None
                           else device)
        return CUDA_AUTO_LAYOUT if dev.type == "cuda" else "NCHW"
    if cfg.lower() not in ("nhwc", "nchw"):
        raise ValueError(f"conv_layout={cfg!r}: auto | nhwc | nchw")
    return cfg.upper()


def to_nhwc(x, n, c, h, w, site: str = "to_nhwc"):
    """(N, C*H*W) flattened -> (N, H, W, C); the transpose is counted."""
    t = _nchw(x, n, c, h, w).permute(0, 2, 3, 1).contiguous()
    _count_transpose(t, site)
    return t


def from_nhwc(t, site: str = "from_nhwc"):
    """(N, H, W, C) -> flattened (N, C*H*W); the transpose is counted."""
    u = t.permute(0, 3, 1, 2).contiguous()
    _count_transpose(u, site)
    return u.reshape(t.shape[0], -1)


def _as_nchw_view(t):
    """A raw (N, H, W, C) tensor as an NCHW-shaped channels-last view
    (no copy): the form torch's conv and pool kernels take."""
    return t.permute(0, 3, 1, 2)


def _to_raw_nhwc(out):
    """A 4-D NCHW-shaped result as a (N, H, W, C) contiguous tensor (no
    copy when the result is channels-last, as cuDNN's is for a
    channels-last input)."""
    return out.permute(0, 2, 3, 1).contiguous()


def _input(x, n, c, h, w, nhwc: bool, nhwc_in: bool, site: str):
    """The op's input as an NCHW-shaped tensor, channels-last when the
    op computes in NHWC."""
    if nhwc_in:
        return _as_nchw_view(x)
    if nhwc:
        return _as_nchw_view(to_nhwc(x, n, c, h, w, site))
    return _nchw(x, n, c, h, w)


def _output(out, nhwc: bool, nhwc_out: bool, site: str):
    """An NCHW-shaped result in the form the op gives: raw NHWC, or the
    flattened boundary form."""
    if nhwc_out:
        return _to_raw_nhwc(out)
    if nhwc:
        return from_nhwc(_to_raw_nhwc(out), site)
    return out.reshape(out.shape[0], -1)


# --------------------------------------------------------------------------
# conv algorithm selection (cached per geometry)
# --------------------------------------------------------------------------

_ALGO_CACHE: Dict[Tuple, str] = {}


def conv_algo(n, c, h, w, f, hf, wf, sh, sw, ph, pw, groups,
              device=None) -> str:
    """"conv" (cuDNN, F.conv2d) or "im2col" for one conv geometry,
    cached per (device type, setting, budget, geometry), so that the
    backward ops of a layer take the arm its forward took. groups > 1
    always takes "conv" (im2col has no grouped form); a forced setting
    is taken as it is. "auto" on the CPU is the JAX package's rule
    (kernels under 5x5 take "conv", larger ones "im2col" while the patch
    tensor stays within an eighth of the budget), on the card
    CUDA_AUTO_ALGO."""
    cfg = get_config()
    forced = cfg.conv_algorithm
    if forced not in ("auto", "conv", "im2col"):
        raise ValueError(f"conv_algorithm={forced!r}: auto | conv | im2col")
    dev = torch.device(cfg.device if device is None else device)
    key = (dev.type, forced, cfg.mem_budget_bytes,
           n, c, h, w, f, hf, wf, sh, sw, ph, pw, groups)
    algo = _ALGO_CACHE.get(key)
    if algo is None:
        if int(groups) != 1:
            algo = "conv"
        elif forced in ("conv", "im2col"):
            algo = forced
        elif dev.type == "cuda":
            algo = CUDA_AUTO_ALGO
        elif hf < 5 and wf < 5:
            algo = "conv"
        else:
            hout = out_dim(h, hf, sh, ph)
            wout = out_dim(w, wf, sw, pw)
            patch_bytes = float(n) * c * hf * wf * hout * wout * 4
            from systemml_tpu_torch.hops.cost import HwProfile

            cap = cfg.mem_budget_bytes or HwProfile.detect().hbm_bytes
            algo = "im2col" if patch_bytes <= cap / 8 else "conv"
        _ALGO_CACHE[key] = algo
    st = _stats()
    if st is not None:
        st.count_estim(f"dnn_algo_{algo}[{hf}x{wf}s{sh}c{c}g{groups}]")
    return algo


def _geometry(input_shape, filter_shape, stride, padding):
    n, c, h, w = (int(v) for v in input_shape)
    f, ci, hf, wf = (int(v) for v in filter_shape)
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(padding[0]), int(padding[1])
    return n, c, h, w, f, ci, hf, wf, sh, sw, ph, pw


def _im2col_fwd(xt, wmat, hf, wf, sh, sw, ph, pw):
    """unfold + one matmul: (n, c*hf*wf, L) patches, c-major then (i, j),
    as the OIHW filter flattens."""
    n, _, h, w = xt.shape
    hout, wout = out_dim(h, hf, sh, ph), out_dim(w, wf, sw, pw)
    cols = F.unfold(xt, (hf, wf), padding=(ph, pw), stride=(sh, sw))
    wm, cols = bf16_operands(wmat, cols)
    return torch.matmul(wm, cols).reshape(n, wmat.shape[0], hout, wout)


def conv2d(x, w, input_shape, filter_shape, stride, padding, groups=1,
           nhwc_in: bool = False, nhwc_out: bool = False):
    """conv2d(X, W) -> (N, F*Hout*Wout) (reference: builtin CONV2D);
    groups > 1 is a grouped or depthwise conv. `nhwc_in` / `nhwc_out`:
    X arrives / the result leaves as a raw (N, H, W, C) tensor."""
    n, c, h, wd, f, ci, hf, wf, sh, sw, ph, pw = _geometry(
        input_shape, filter_shape, stride, padding)
    algo = conv_algo(n, c, h, wd, f, hf, wf, sh, sw, ph, pw, int(groups),
                     x.device)
    nhwc = device_layout(x.device) == "NHWC" or nhwc_in or nhwc_out
    _count_layer("conv", f"{algo},{'NHWC' if nhwc else 'NCHW'},"
                         f"{hf}x{wf}s{sh},{c}x{h}x{wd}")
    xt = _input(x, n, c, h, wd, nhwc, nhwc_in, "conv_in")
    if algo == "im2col":
        out = _im2col_fwd(xt, w.reshape(f, ci * hf * wf), hf, wf, sh, sw,
                          ph, pw)
    else:
        wt = _nchw(w, f, ci, hf, wf)
        if nhwc:
            wt = wt.contiguous(memory_format=torch.channels_last)
        xt, wt = bf16_operands(xt, wt)
        out = F.conv2d(xt, wt, stride=(sh, sw), padding=(ph, pw),
                       groups=int(groups))
    return _output(out, nhwc, nhwc_out, "conv_out")


def conv2d_bias_add(x, b, w, input_shape, filter_shape, stride, padding):
    """conv2d + bias_add (reference: the CONV2D_BIAS_ADD fusion)."""
    out = conv2d(x, w, input_shape, filter_shape, stride, padding)
    return bias_add(out, b, num_channels=filter_shape[0])


def _dout4(dout, n, f, hout, wout, nhwc: bool):
    d = dout.reshape(n, f, hout, wout)
    return d.contiguous(memory_format=torch.channels_last) if nhwc else d


def conv2d_backward_filter(x, dout, input_shape, filter_shape, stride,
                           padding, groups=1):
    """dW of conv2d (reference: CONV2D_BACKWARD_FILTER), the adjoint of
    the arm `conv_algo` chose for the forward: aten's
    convolution_backward for "conv", dout times the unfolded patches for
    "im2col"."""
    n, c, h, wd, f, ci, hf, wf, sh, sw, ph, pw = _geometry(
        input_shape, filter_shape, stride, padding)
    algo = conv_algo(n, c, h, wd, f, hf, wf, sh, sw, ph, pw, int(groups),
                     x.device)
    nhwc = device_layout(x.device) == "NHWC"
    hout, wout = out_dim(h, hf, sh, ph), out_dim(wd, wf, sw, pw)
    xt = _input(x, n, c, h, wd, nhwc, False, "conv_in")
    d = _dout4(dout, n, f, hout, wout, nhwc)
    if algo == "im2col":
        cols = F.unfold(xt, (hf, wf), padding=(ph, pw), stride=(sh, sw))
        d3, cols = bf16_operands(d.reshape(n, f, hout * wout), cols)
        return torch.matmul(d3, cols.transpose(1, 2)).sum(0)
    xt, d = bf16_operands(xt, d)
    # only the filter's shape is read: an expanded one-element tensor
    wshape = xt.new_empty(1).expand(f, ci, hf, wf)
    _, dw, _ = torch.ops.aten.convolution_backward(
        d, xt, wshape, None, [sh, sw], [ph, pw], [1, 1], False, [0, 0],
        int(groups), [False, True, False])
    return dw.reshape(f, -1).contiguous()


def conv2d_backward_data(w, dout, input_shape, filter_shape, stride,
                         padding, groups=1):
    """dX of conv2d (reference: CONV2D_BACKWARD_DATA), the adjoint of the
    forward's arm: aten's convolution_backward for "conv", fold of
    t(W) %*% dout for "im2col". Also the forward op of a transpose
    convolution (the caller passes the underlying conv's geometry)."""
    n, c, h, wd, f, ci, hf, wf, sh, sw, ph, pw = _geometry(
        input_shape, filter_shape, stride, padding)
    algo = conv_algo(n, c, h, wd, f, hf, wf, sh, sw, ph, pw, int(groups),
                     w.device)
    nhwc = device_layout(w.device) == "NHWC"
    hout, wout = out_dim(h, hf, sh, ph), out_dim(wd, wf, sw, pw)
    d = _dout4(dout, n, f, hout, wout, nhwc)
    if algo == "im2col":
        wm, d3 = bf16_operands(w.reshape(f, ci * hf * wf),
                               d.reshape(n, f, hout * wout))
        cols = torch.matmul(wm.T, d3)
        dx = F.fold(cols, (h, wd), (hf, wf), padding=(ph, pw),
                    stride=(sh, sw))
        return dx.reshape(n, -1)
    wt = _nchw(w, f, ci, hf, wf)
    if nhwc:
        wt = wt.contiguous(memory_format=torch.channels_last)
    wt, d = bf16_operands(wt, d)
    xshape = wt.new_empty(1).expand(n, c, h, wd)
    dx, _, _ = torch.ops.aten.convolution_backward(
        d, xshape, wt, None, [sh, sw], [ph, pw], [1, 1], False, [0, 0],
        int(groups), [True, False, False])
    return dx.contiguous().reshape(n, -1)


# --------------------------------------------------------------------------
# pooling
# --------------------------------------------------------------------------

def _pool_geometry(input_shape, pool_size, stride, padding):
    n, c, h, w = (int(v) for v in input_shape)
    hp, wp = int(pool_size[0]), int(pool_size[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(padding[0]), int(padding[1])
    return n, c, h, w, hp, wp, sh, sw, ph, pw


def _torch_pads(hp, wp, ph, pw) -> bool:
    """Whether torch's pooling kernels take this padding themselves (at
    most half the window); a wider one is padded explicitly first."""
    return ph <= hp // 2 and pw <= wp // 2


def _pool(x, input_shape, pool_size, stride, padding, kind: str,
          nhwc_in: bool = False, nhwc_out: bool = False):
    n, c, h, w, hp, wp, sh, sw, ph, pw = _pool_geometry(
        input_shape, pool_size, stride, padding)
    nhwc = device_layout(x.device) == "NHWC" or nhwc_in or nhwc_out
    _count_layer("pool", f"{kind},{'NHWC' if nhwc else 'NCHW'},"
                         f"{hp}x{wp}s{sh},{c}x{h}x{w}")
    xt = _input(x, n, c, h, w, nhwc, nhwc_in, "pool_in")
    pads = (ph, pw)
    if not _torch_pads(hp, wp, ph, pw):
        # the JAX package pads max with -inf and avg with 0, any width
        xt = F.pad(xt, (pw, pw, ph, ph),
                   value=float("-inf") if kind == "max" else 0.0)
        pads = (0, 0)
    if kind == "max":
        out = F.max_pool2d(xt, (hp, wp), (sh, sw), pads)
    else:
        # the reference divides by the window size, padding included
        out = F.avg_pool2d(xt, (hp, wp), (sh, sw), pads,
                           count_include_pad=True, divisor_override=hp * wp)
    return _output(out, nhwc, nhwc_out, "pool_out")


def max_pool(x, input_shape, pool_size, stride, padding,
             nhwc_in=False, nhwc_out=False):
    return _pool(x, input_shape, pool_size, stride, padding, "max",
                 nhwc_in, nhwc_out)


def avg_pool(x, input_shape, pool_size, stride, padding,
             nhwc_in=False, nhwc_out=False):
    return _pool(x, input_shape, pool_size, stride, padding, "avg",
                 nhwc_in, nhwc_out)


def max_pool_backward(x, dout, input_shape, pool_size, stride, padding):
    """dX of max pooling, as the JAX package gives it: in the
    non-overlapping case (stride = pool, no padding, dividing evenly) a
    tied window's gradient is split equally between its maxima; else
    each window's gradient goes to one winner, the first maximum in the
    window's row-major order (XLA's select_and_scatter with `ge`, and
    aten's max_pool2d indices alike), padding counting as -inf."""
    n, c, h, w, hp, wp, sh, sw, ph, pw = _pool_geometry(
        input_shape, pool_size, stride, padding)
    if ((hp, wp) == (sh, sw) and (ph, pw) == (0, 0)
            and h % hp == 0 and w % wp == 0):
        oh, ow = h // hp, w // wp
        blocks = _nchw(x, n, c, h, w).reshape(n, c, oh, hp, ow, wp)
        m = blocks.amax(dim=(3, 5), keepdim=True)
        mask = blocks == m
        cnt = mask.sum(dim=(3, 5), keepdim=True).to(x.dtype)
        d = dout.reshape(n, c, oh, 1, ow, 1)
        g = torch.where(mask, d / cnt, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
        return g.reshape(n, -1)
    xt = _nchw(x, n, c, h, w)
    pads = (ph, pw)
    wide = not _torch_pads(hp, wp, ph, pw)
    if wide:
        xt = F.pad(xt, (pw, pw, ph, ph), value=float("-inf"))
        pads = (0, 0)
    out, idx = torch.ops.aten.max_pool2d_with_indices(
        xt, [hp, wp], [sh, sw], list(pads), [1, 1], False)
    dx = torch.ops.aten.max_pool2d_with_indices_backward(
        dout.reshape(out.shape), xt, [hp, wp], [sh, sw], list(pads),
        [1, 1], False, idx)
    if wide:
        dx = dx[:, :, ph:ph + h, pw:pw + w]
    return dx.contiguous().reshape(n, -1)


def avg_pool_backward(x, dout, input_shape, pool_size, stride, padding):
    """dX of average pooling: each window's gradient over its cells,
    divided by the window size (padding included)."""
    n, c, h, w, hp, wp, sh, sw, ph, pw = _pool_geometry(
        input_shape, pool_size, stride, padding)
    xt = _nchw(x, n, c, h, w)
    pads = (ph, pw)
    wide = not _torch_pads(hp, wp, ph, pw)
    if wide:
        xt = F.pad(xt, (pw, pw, ph, ph))
        pads = (0, 0)
    hout = out_dim(xt.shape[2], hp, sh, pads[0])
    wout = out_dim(xt.shape[3], wp, sw, pads[1])
    dx = torch.ops.aten.avg_pool2d_backward(
        dout.reshape(n, c, hout, wout), xt, [hp, wp], [sh, sw],
        list(pads), False, True, hp * wp)
    if wide:
        dx = dx[:, :, ph:ph + h, pw:pw + w]
    return dx.contiguous().reshape(n, -1)


# --------------------------------------------------------------------------
# bias, relu, softmax
# --------------------------------------------------------------------------

def _bias_op(x, b, num_channels: int, nhwc_in: bool, nhwc_out: bool, op):
    c = int(num_channels)
    if nhwc_in:
        out = op(x, b.reshape(1, 1, 1, c))
        return out if nhwc_out else from_nhwc(out, "bias_out")
    n = x.shape[0]
    pix = x.shape[1] // c
    return op(x.reshape(n, c, pix), b.reshape(1, c, 1)).reshape(n, -1)


def bias_add(x, b, num_channels: int, nhwc_in: bool = False,
             nhwc_out: bool = False):
    """bias_add(X, b): b[c] added to every value of channel c (reference:
    builtin BIAS_ADD). With `nhwc_in` X is a raw (N, H, W, C) tensor; an
    NHWC output needs an NHWC input (a flattened X does not carry H and W
    apart, so bias_add can continue an NHWC chain, never start one)."""
    return _bias_op(x, b, num_channels, nhwc_in, nhwc_out, torch.add)


def bias_multiply(x, b, num_channels: int, nhwc_in: bool = False,
                  nhwc_out: bool = False):
    return _bias_op(x, b, num_channels, nhwc_in, nhwc_out, torch.mul)


def relu(x):
    return torch.clamp_min(x, 0)


def relu_backward(x, dout):
    return torch.where(x > 0, dout, torch.zeros((), dtype=dout.dtype,
                                                 device=dout.device))


def softmax_rows(x):
    return torch.softmax(x, dim=-1)


# --------------------------------------------------------------------------
# the fused recurrent and normalization ops
# --------------------------------------------------------------------------

def lstm(x, w, b, out0, c0, return_sequences: bool = True):
    """LSTM forward over T steps (the JAX package's lax.scan is a loop
    over T here, which a loop region captures whole). Layout of
    scripts/nn/layers/lstm.dml: X (N, T*D), timesteps along the columns;
    W (D+M, 4M), gates [input, forget, output, g]; b (1, 4M); out0 and
    c0 (N, M). Returns (out, c): out (N, T*M) with return_sequences,
    else (N, M)."""
    n, m = out0.shape
    d = w.shape[0] - m
    t = x.shape[1] // d
    xs = x.reshape(n, t, d)
    out, c = out0, c0
    outs = []
    for step in range(t):
        ifog = torch.matmul(*bf16_operands(
            torch.cat([xs[:, step, :], out], dim=1), w)) + b
        i, f, o, g = torch.split(ifog, m, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        out = torch.sigmoid(o) * torch.tanh(c)
        outs.append(out)
    if return_sequences:
        return torch.stack(outs, dim=1).reshape(n, t * m), c
    return out, c


def batch_norm2d(x, gamma, beta, ema_mean, ema_var, input_shape,
                 mode: str = "train", epsilon: float = 1e-5,
                 momentum: float = 0.9):
    """Spatial batch norm (layout of scripts/nn/layers/batch_norm2d.dml:
    X (N, C*H*W), gamma, beta and the EMAs (C, 1)). Returns (out,
    ema_mean_upd, ema_var_upd, cache_mean, cache_inv_var); in test mode
    the EMAs normalise and come back as they were."""
    n, c, h, w = (int(v) for v in input_shape)
    xt = x.reshape(n, c, h * w)
    if mode == "train":
        mean = xt.mean(dim=(0, 2)).reshape(c, 1)
        var = xt.var(dim=(0, 2), unbiased=False).reshape(c, 1)
        ema_mean_upd = momentum * ema_mean + (1 - momentum) * mean
        ema_var_upd = momentum * ema_var + (1 - momentum) * var
    else:
        mean, var = ema_mean, ema_var
        ema_mean_upd, ema_var_upd = ema_mean, ema_var
    inv_std = torch.rsqrt(var + epsilon)
    norm = (xt - mean.reshape(1, c, 1)) * inv_std.reshape(1, c, 1)
    out = gamma.reshape(1, c, 1) * norm + beta.reshape(1, c, 1)
    return out.reshape(n, -1), ema_mean_upd, ema_var_upd, mean, inv_std
