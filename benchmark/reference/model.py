"""Plain f32 reference of the two SKOOTS backbones and their heads.

Written from the published description (buswinka/skoots ``skoots/config.py``,
``skoots/lib/utils.py``: bism's ``UNeXT_3D`` and ``UNet_3D`` under a
SpatialEmbedding head) in plain PyTorch, channels-last ``[B, X, Y, Z, C]``,
float32 throughout, TF32 off. It imports nothing of the program; it reads
the parameters from a flat dict keyed as the program's ``state_dict`` (the
benchmark builds that dict itself, from the seed or from a ``.skoots`` file
through ``reference/ckpt.py``).

UNeXT3D: a k^3 stem from the one input channel; per encoder stage ``depth``
ConvNeXt blocks (depthwise k^3 conv, LayerNorm, Dense 4C, exact GELU, Dense
C, layer scale gamma, residual), then LayerNorm and a stride-2 2^3 conv; a
bottleneck stage; per decoder stage a 2x trilinear upsample (half-pixel
centres, edges clamped), the skip concatenated, a 1x1 conv and ``depth``
blocks; a final LayerNorm and 1x1 conv to 32 features. UNet3D: per stage
``depth`` times a 3^3 conv, GroupNorm of min(8, C) groups and the
activation; 2^3 max pools down, the same upsample up. Heads: three 1x1
convs, tanh on the 3 vector channels, sigmoid on skeleton and semantic.

Departures from the published description, each shared with the program:
LayerNorm and GroupNorm eps 1e-6 (flax's; PyTorch's bism uses 1e-6 for its
LayerNorm too); the depthwise convs are computed through FFTs
(:func:`dwconv`), which is the same linear map in f32 with a different
rounding order; the 1x1 convs as matmuls.

``q``, when given, is applied to both operands of every convolution and
matmul: the control's lower precision (``reference/quant.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def _fast(n: int) -> int:
    """The least 5-smooth number >= n (a fast FFT length)."""
    m = n
    while True:
        r = m
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def dwconv(x, w, b, q=None):
    """Depthwise k^3 SAME (zero-padded) correlation of ``x`` ``[B, X, Y, Z,
    C]`` (or one channel, broadcast to all C: the stem) with ``w`` ``[k, k,
    k, C]`` plus ``b``; by FFT of length >= n + k - 1 an axis, f32."""
    if q is not None:
        x, w = q(x), q(w)
    k = w.shape[0]
    h = k // 2
    spatial = x.shape[1:4]
    s = [_fast(n + k - 1) for n in spatial]
    xc = x.movedim(-1, 1)  # [B, C|1, X, Y, Z]
    wf = torch.flip(w, (0, 1, 2)).movedim(-1, 0)[None]  # [1, C, k, k, k]
    fx = torch.fft.rfftn(xc, s=s, dim=(2, 3, 4))
    fw = torch.fft.rfftn(wf, s=s, dim=(2, 3, 4))
    full = torch.fft.irfftn(fx * fw, s=s, dim=(2, 3, 4))
    y = full[:, :, h:h + spatial[0], h:h + spatial[1], h:h + spatial[2]]
    return y.movedim(1, -1) + b


def dense(x, w, b, q=None):
    if q is not None:
        x, w = q(x), q(w)
    return x @ w + b


def conv(x, w, b, stride: int = 1, q=None):
    """Dense conv, ``w`` ``[k, k, k, Cin, Cout]`` (SAME for stride 1, VALID
    2^3 for the stride-2 downsample)."""
    if q is not None:
        x, w = q(x), q(w)
    k = w.shape[0]
    pad = k // 2 if stride == 1 else 0
    y = F.conv3d(x.movedim(-1, 1), w.permute(4, 3, 0, 1, 2), stride=stride, padding=pad)
    return y.movedim(1, -1) + b


def layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * scale + bias


def group_norm(x, scale, bias, groups: int):
    c = x.shape[-1]
    g = x.reshape(x.shape[0], -1, groups, c // groups)
    mean = g.mean((1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean((1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    return y * scale + bias


ACT = {"gelu": lambda x: F.gelu(x), "relu": F.relu, "silu": F.silu, "selu": F.selu}


def upsample(x):
    y = F.interpolate(x.movedim(-1, 1), scale_factor=2, mode="trilinear",
                      align_corners=False)
    return y.movedim(1, -1)


def _block(p, name, x, act, q):
    h = dwconv(x, p[f"{name}.dwconv.weight"], p[f"{name}.dwconv.bias"], q)
    y = layer_norm(h, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"])
    y = ACT[act](dense(y, p[f"{name}.pw1.weight"], p[f"{name}.pw1.bias"], q))
    y = dense(y, p[f"{name}.pw2.weight"], p[f"{name}.pw2.bias"], q)
    g = p.get(f"{name}.gamma")
    return x + (y * g if g is not None else y)


def unext(p, m, x, q=None):
    dims, depths = m["DIMS"], m["DEPTHS"]
    kd = len(dims) // 2
    act = m["ACTIVATION"]
    b = "backbone"
    x = dwconv(x, p[f"{b}.stem.weight"], p[f"{b}.stem.bias"], q)
    skips = []

    def stage(x, name, depth):
        for i in range(depth):
            x = _block(p, f"{b}.{name}_block{i}", x, act, q)
        return x

    for s in range(kd):
        x = stage(x, f"enc{s}", depths[s])
        skips.append(x)
        d = f"{b}.down{s}"
        x = conv(layer_norm(x, p[f"{d}.norm.weight"], p[f"{d}.norm.bias"]),
                 p[f"{d}.conv.weight"], p[f"{d}.conv.bias"], stride=2, q=q)
    x = stage(x, "bottleneck", depths[kd])
    for s in range(kd):
        x = torch.cat([upsample(x), skips[kd - 1 - s]], -1)
        x = dense(x, p[f"{b}.concat{s}.fuse.weight"], p[f"{b}.concat{s}.fuse.bias"], q)
        x = stage(x, f"dec{s}", depths[kd + 1 + s])
    x = layer_norm(x, p[f"{b}.final_norm.weight"], p[f"{b}.final_norm.bias"])
    return dense(x, p[f"{b}.head_conv.weight"], p[f"{b}.head_conv.bias"], q)


def unet(p, m, x, q=None):
    dims, depths = m["DIMS"], m["DEPTHS"]
    kd = len(dims) // 2
    act = m["ACTIVATION"]
    b = "backbone"

    def stage(x, name, depth, dim):
        for i in range(depth):
            x = conv(x, p[f"{b}.{name}_conv{i}.weight"], p[f"{b}.{name}_conv{i}.bias"], q=q)
            x = group_norm(x, p[f"{b}.{name}_gn{i}.weight"], p[f"{b}.{name}_gn{i}.bias"],
                           min(8, dim))
            x = ACT[act](x)
        return x

    skips = []
    for s in range(kd):
        x = stage(x, f"enc{s}", depths[s], dims[s])
        skips.append(x)
        x = F.max_pool3d(x.movedim(-1, 1), 2, 2).movedim(1, -1)
    x = stage(x, "bottleneck", depths[kd], dims[kd])
    for s in range(kd):
        x = torch.cat([upsample(x), skips[kd - 1 - s]], -1)
        x = stage(x, f"dec{s}", depths[kd + 1 + s], dims[kd + 1 + s])
    return dense(x, p[f"{b}.head_conv.weight"], p[f"{b}.head_conv.bias"], q)


def forward(p, m, x, q=None):
    """``x`` ``[B, X, Y, Z, 1]`` f32 -> ``[B, X, Y, Z, 5]``: tanh vectors,
    sigmoid skeleton and semantic probabilities."""
    arch = m["ARCHITECTURE"]
    feat = (unext if arch in ("bism_unext", "unext") else unet)(p, m, x, q)
    w = torch.cat([p[f"{h}.weight"] for h in ("vector_head", "skeleton_head",
                                              "semantic_head")], 1)
    bb = torch.cat([p[f"{h}.bias"] for h in ("vector_head", "skeleton_head",
                                             "semantic_head")])
    y = dense(feat, w, bb, q)
    return torch.cat([torch.tanh(y[..., 0:3]), torch.sigmoid(y[..., 3:5])], -1)


def no_tf32():
    """Plain f32 on the card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_count(p: dict) -> int:
    return sum(math.prod(v.shape) for v in p.values())
