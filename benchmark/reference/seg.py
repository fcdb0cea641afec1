"""Plain reference of the segmentation pipeline, and the comparisons that
decide a segmentation cell's ``correct``.

The pipeline as SKOOTS publishes it (``skoots/lib/vec2embed.py``, the
reference's ``skoots.py`` inference): normalise the block, run the model
over a static grid of tiles (reflect padding where a tile passes the edge),
gate vectors and skeleton by ``semantic > thr``, dilate the skeleton (3D
26-neighbourhood max ``d3`` times, then in-plane 3x3 ``d2`` times, zero
padding at the tile's edges), threshold it; label its 26-connected
components (``scipy.ndimage.label``); for every semantic-foreground voxel,
walk ``N`` steps of ``position += vector * scale`` inside its assign tile
(indices rounded half to even and clamped to the tile), then take the
component label at the walk's end, clamped to the block. All f32 on the
card; the CC on the host. Departures shared with the program: the tile
grid and the assign grid are the program's (its ``_device_geometry``
defaults), and later assign tiles overwrite earlier ones where the last
tile of an axis is clamped back.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref_model


def axis_origins(size: int, crop: int, overlap: int) -> list:
    if crop >= size:
        return [0]
    stride = crop - 2 * overlap
    origins, x = [], 0
    while True:
        origins.append(min(x, size - crop))
        if x >= size - crop:
            return origins
        x += stride


def crop_origins(shape, crop, overlap=(0, 0, 0)) -> list:
    crop = [min(c, s) for c, s in zip(crop, shape)]
    axes = [axis_origins(s, c, o) for s, c, o in zip(shape, crop, overlap)]
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


def tile_grid(shape, crop):
    """(crop, pads, padded shape, origins) of a grid with no overlap; the
    crop clamped to each axis rounded down to a multiple of 4."""
    crop = tuple(min(c, max(4, d // 4 * 4)) for c, d in zip(crop, shape))
    pads = [(0, max(0, c - d)) for d, c in zip(shape, crop)]
    padded = tuple(d + p[1] for d, p in zip(shape, pads))
    return crop, pads, padded, crop_origins(padded, crop)


def _dilate(s, window):
    x = s.movedim(-1, 1)
    pad = []
    for w in reversed(window):
        pad += [(w - 1) // 2, (w - 1) // 2]
    y = F.max_pool3d(F.pad(x, pad, value=0.0), tuple(window), stride=1).clamp_min(0)
    return y.movedim(1, -1)


def segment(params, mcfg, volume, mean, std, knobs, device, q=None, keep_tiles=()):
    """The reference's instance labels of ``volume`` (uint8 numpy ``[X, Y,
    Z]``): ``(labels int32 [X, Y, Z] on the host, {tile index: its model
    output f32 on the host} for ``keep_tiles``)``."""
    crop, pads, padded, origins = tile_grid(volume.shape, knobs["crop"])
    thr, sem_thr = float(knobs["prob_threshold"]), float(knobs["semantic_threshold"])
    x, y, z = volume.shape
    v = (torch.from_numpy(volume).to(device).float() - float(mean)) / float(std)
    if any(p[1] for p in pads):
        v = F.pad(v[None, None], [pads[2][0], pads[2][1], pads[1][0], pads[1][1],
                                  pads[0][0], pads[0][1]], mode="reflect")[0, 0]
    vec = torch.zeros((*padded, 3), dtype=torch.float32, device=device)
    mask = torch.zeros(padded, dtype=torch.uint8, device=device)
    kept = {}
    with torch.no_grad():
        for i, o in enumerate(origins):
            sl = tuple(slice(a, a + c) for a, c in zip(o, crop))
            out = ref_model.forward(params, mcfg, v[sl][None, ..., None], q)[0]
            if i in keep_tiles:
                kept[i] = out.cpu()
            keep = (out[..., 4:5] > thr).float()
            s = out[..., 3:4] * keep
            for _ in range(int(knobs["dilation_3d"])):
                s = _dilate(s[None], (3, 3, 3))[0]
            for _ in range(int(knobs["dilation_2d"])):
                s = _dilate(s[None], (3, 3, 1))[0]
            vec[sl] = out[..., 0:3] * keep
            mask[sl] = (s[..., 0] > thr).to(torch.uint8) | (
                (out[..., 4] > sem_thr).to(torch.uint8) << 1)
            del out, s, keep
    del v
    vec, mask = vec[:x, :y, :z], mask[:x, :y, :z]
    skel = (mask & 1).cpu().numpy()
    cc, _ = scipy.ndimage.label(skel, structure=np.ones((3, 3, 3), bool))
    labels = torch.from_numpy(cc.astype(np.int32)).to(device)
    inst = assign(vec, (mask >> 1) > 0, labels, knobs, device)
    return inst.cpu().numpy(), kept


def assign(vec, fg, labels, knobs, device):
    """Each foreground voxel walks N steps inside its assign tile, then
    takes the label at the walk's end."""
    x, y, z = labels.shape
    a_crop = tuple(min(c, max(4, d // 4 * 4)) for c, d in zip(knobs["crop"], (x, y, z)))
    scale = torch.tensor(knobs["vector_scale"], dtype=torch.float32, device=device)
    sizes = torch.tensor(a_crop, device=device)
    inst = torch.zeros((x, y, z), dtype=torch.int32, device=device)
    n = int(knobs["embed_iterations"])
    for o in crop_origins((x, y, z), a_crop):
        sl = tuple(slice(a, a + c) for a, c in zip(o, a_crop))
        vt, ft = vec[sl], fg[sl]
        idx = torch.nonzero(ft)
        cur = vt[idx[:, 0], idx[:, 1], idx[:, 2]] * scale + idx.float()
        for _ in range(n - 1):
            j = torch.round(cur).long().clamp(min=torch.zeros_like(sizes), max=sizes - 1)
            cur = vt[j[:, 0], j[:, 1], j[:, 2]] * scale + cur
        g = torch.round(cur).long() + torch.tensor(o, device=device)
        tile = torch.zeros(a_crop, dtype=torch.int32, device=device)
        tile[idx[:, 0], idx[:, 1], idx[:, 2]] = labels[
            g[:, 0].clamp(0, x - 1), g[:, 1].clamp(0, y - 1), g[:, 2].clamp(0, z - 1)]
        inst[sl] = tile
    return inst


def _majority_miss(a: torch.Tensor, b: torch.Tensor) -> int:
    """Voxels of ``a``'s labels that do not lie in the label of ``b`` that
    most of their ``a`` label lies in (``a`` and ``b`` 1-D, same length)."""
    if a.numel() == 0:
        return 0
    ua, ia = torch.unique(a, return_inverse=True)
    ub, ib = torch.unique(b, return_inverse=True)
    pair = ia.long() * len(ub) + ib.long()
    up, counts = torch.unique(pair, return_counts=True)
    best = torch.zeros(len(ua), dtype=counts.dtype, device=a.device)
    best.scatter_reduce_(0, up // len(ub), counts, reduce="amax")
    return int(a.numel() - best.sum())


def partition_mismatch(p, r) -> float:
    """The share of the voxels that either labelling calls foreground and
    that the other splits off or merges away: the larger of the two
    directions' majority misses, over the union of foregrounds."""
    p = torch.as_tensor(p).reshape(-1)
    r = torch.as_tensor(r).reshape(-1)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    p, r = p.to(dev), r.to(dev)
    sel = (p > 0) | (r > 0)
    n = int(sel.sum())
    if n == 0:
        return 0.0
    a, b = p[sel], r[sel]
    return max(_majority_miss(a, b), _majority_miss(b, a)) / n


def cc_mismatch(fg: np.ndarray, labels: np.ndarray) -> int:
    """Voxels where the program's component labels of its own skeleton mask
    ``fg`` differ from the 26-connected components of that mask: labels on
    background, and voxels split off or merged away (both directions)."""
    cc, _ = scipy.ndimage.label(fg > 0, structure=np.ones((3, 3, 3), bool))
    on_bg = int(((fg == 0) & (labels != 0)).sum())
    sel = fg.reshape(-1) > 0
    a = torch.from_numpy(labels.reshape(-1)[sel].astype(np.int64))
    b = torch.from_numpy(cc.reshape(-1)[sel].astype(np.int64))
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a, b = a.to(dev), b.to(dev)
    return on_bg + _majority_miss(a, b) + _majority_miss(b, a)


def fg_mismatch(p, r) -> float:
    """The share of the union of foregrounds that only one side calls
    foreground."""
    p = torch.as_tensor(p).reshape(-1)
    r = torch.as_tensor(r).reshape(-1)
    union = int(((p > 0) | (r > 0)).sum())
    return int(((p > 0) ^ (r > 0)).sum()) / max(union, 1)


def unmatched(p, r) -> tuple:
    """(reference instances, program instances) with no partner at IoU >=
    0.5 on the other side, and the sizes of the five largest unmatched
    reference instances."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    p = torch.as_tensor(p).reshape(-1).to(dev).long()
    r = torch.as_tensor(r).reshape(-1).to(dev).long()
    sel = (p > 0) | (r > 0)
    p, r = p[sel], r[sel]
    up, ip = torch.unique(p, return_inverse=True)
    ur, ir = torch.unique(r, return_inverse=True)
    sp = torch.bincount(ip, minlength=len(up))
    sr = torch.bincount(ir, minlength=len(ur))
    pair, inter = torch.unique(ip * len(ur) + ir, return_counts=True)
    a, b = pair // len(ur), pair % len(ur)
    iou = inter.float() / (sp[a] + sr[b] - inter).float()
    ok = (iou >= 0.5) & (up[a] > 0) & (ur[b] > 0)
    good_r = torch.zeros(len(ur), dtype=torch.bool, device=dev)
    good_p = torch.zeros(len(up), dtype=torch.bool, device=dev)
    good_r[b[ok]] = True
    good_p[a[ok]] = True
    miss_r = (~good_r) & (ur > 0)
    miss_p = (~good_p) & (up > 0)
    sizes = sorted(sr[miss_r].tolist(), reverse=True)[:5]
    return int(miss_r.sum()), int(miss_p.sum()), sizes


def iou_miss(p, r, q: float) -> float:
    """The ``q`` quantile over the reference's instances of 1 - the IoU with
    the program instance that overlaps it most: the median (``q`` 0.5) says
    how well instances agree voxel by voxel, unmoved by one instance merged
    or split; the 90th percentile sees a fault that mislabels a tenth of the
    instances or more."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    p = torch.as_tensor(p).reshape(-1).to(dev).long()
    r = torch.as_tensor(r).reshape(-1).to(dev).long()
    sel = (p > 0) | (r > 0)
    p, r = p[sel], r[sel]
    up, ip = torch.unique(p, return_inverse=True)
    ur, ir = torch.unique(r, return_inverse=True)
    if int((ur > 0).sum()) == 0:
        return 0.0
    sp = torch.bincount(ip, minlength=len(up))
    sr = torch.bincount(ir, minlength=len(ur))
    pair, inter = torch.unique(ip * len(ur) + ir, return_counts=True)
    a, b = pair // len(ur), pair % len(ur)
    iou = torch.where(up[a] > 0, inter.float() / (sp[a] + sr[b] - inter).float(), 0.0)
    best = torch.zeros(len(ur), device=dev)
    best.scatter_reduce_(0, b, iou, reduce="amax")
    return float(torch.quantile(1.0 - best[ur > 0], q, interpolation="lower"))
