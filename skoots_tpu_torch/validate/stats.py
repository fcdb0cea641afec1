"""Per-object morphometrics and model cost (port of
``skoots_tpu/validate/stats.py:16-111``).

``get_volume``, ``get_surface_area``, ``stats_per_instance`` and
``analytic_unext_flops`` are numpy, copied. Surface area counts exposed
voxel faces (6-connectivity) rather than running marching cubes.
``get_parameter_count`` takes an ``nn.Module``, and ``get_flops`` counts a
torch callable's FLOPs with ``torch.utils.flop_counter.FlopCounterMode``,
where the JAX package asks XLA's cost analysis.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def get_volume(mask: np.ndarray) -> Dict[int, int]:
    """Voxel count per instance id."""
    ids, counts = np.unique(mask[mask > 0], return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts)}


def get_surface_area(mask: np.ndarray) -> Dict[int, int]:
    """Exposed-face count per instance."""
    out: Dict[int, int] = {}
    for uid in np.unique(mask[mask > 0]):
        b = (mask == uid).astype(np.int8)
        faces = 0
        for ax in range(3):
            d = np.diff(b, axis=ax)
            faces += int(np.abs(d).sum())
            # volume-boundary faces
            sl_lo = [slice(None)] * 3
            sl_hi = [slice(None)] * 3
            sl_lo[ax] = 0
            sl_hi[ax] = -1
            faces += int(b[tuple(sl_lo)].sum() + b[tuple(sl_hi)].sum())
        out[int(uid)] = faces
    return out


def get_parameter_count(model: torch.nn.Module) -> int:
    """Total parameter count of ``model``."""
    return int(sum(p.numel() for p in model.parameters()))


def get_flops(fn, *example_args) -> float:
    """FLOPs of one call ``fn(*example_args)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: 2 a
    multiply-accumulate of the matmuls and convolutions that run through
    aten, nothing for elementwise work or for a hand-written kernel, which
    aten does not see (run the plain versions, on CPU tensors, to count
    the model)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*example_args)
    return float(counter.get_total_flops())


def stats_per_instance(mask: np.ndarray) -> Dict[int, Dict[str, int]]:
    """Volume and surface area per instance."""
    vol = get_volume(mask)
    area = get_surface_area(mask)
    return {k: {"volume": vol[k], "surface_area": area.get(k, 0)} for k in vol}


def analytic_unext_flops(
    dims, depths, kernel_size: int, out_channels: int, tile_vox: int
) -> float:
    """Closed-form forward FLOPs of the UNeXT3D for one tile of
    ``tile_vox`` voxels (batch excluded), counting a multiply-accumulate as
    2 FLOPs: the stem (dense 1->C k^3), each stage's ConvNeXt blocks
    (depthwise k^3, LN, pointwise C->4C->C MLP, layer scale), the LN +
    2^3-strided downsamples, the trilinear upsamples, the 1^3 concat
    fusions and the final LN + 1^3 head. Elementwise and LN terms are
    included (under 2% of the total), so the number serves as an absolute
    FLOP/s numerator."""
    k3 = kernel_size ** 3
    n_down = len(dims) // 2
    # voxels at each resolution level: full, /8, /64, ...
    vox = [tile_vox // (8 ** l) for l in range(n_down + 1)]

    def block(v: int, c: int) -> float:
        dw = 2.0 * v * c * k3          # depthwise conv MACs
        ln = 10.0 * v * c              # LayerNorm (mean/var/normalize/affine)
        mlp = 2.0 * v * (c * 4 * c) * 2  # pw1 + pw2
        gelu = 8.0 * v * 4 * c         # activation on the hidden
        tail = 3.0 * v * c             # layer scale + residual
        return dw + ln + mlp + gelu + tail

    total = 2.0 * vox[0] * dims[0] * k3  # stem (dense 1->C == dw on bcast)
    for s in range(n_down):              # encoder stages + downsamples
        total += depths[s] * block(vox[s], dims[s])
        total += 10.0 * vox[s] * dims[s]  # downsample LN
        total += 2.0 * vox[s + 1] * dims[s + 1] * (8 * dims[s])
    total += depths[n_down] * block(vox[n_down], dims[n_down])  # bottleneck
    for s in range(n_down):              # decoder
        d = n_down + 1 + s
        lvl = n_down - 1 - s             # resolution level after upsample
        c_in = dims[d - 1] + dims[lvl]   # upsampled stream + skip
        total += 9.0 * vox[lvl] * dims[d - 1]          # trilinear upsample
        total += 2.0 * vox[lvl] * c_in * dims[d]       # concat fuse 1^3
        total += depths[d] * block(vox[lvl], dims[d])
    total += 10.0 * vox[0] * dims[-1]                  # final LN
    total += 2.0 * vox[0] * dims[-1] * out_channels    # 1^3 head
    return float(total)
