"""Training augmentation on the device (port of
``skoots_tpu/train/transforms.py``).

Per sample: elastic warp, in-plane affine, crop around the sampled
instance, flips, invert / brightness / contrast / noise, normalisation,
then the skeleton bake (the bake kernel, ``kernels/bake.py``) and the
skeleton-mask stamp. Skeleton points are co-transformed through every
spatial op, as in the JAX package.

Randomness: the scalar draws (flags, angles, the 6x6x2 elastic grid) come
from a CPU ``torch.Generator``, so branches need no device sync; the noise
volume comes from a device generator seeded from it. JAX's PRNG cannot be
matched, so the tests hold this against the JAX augmentation with a cfg
whose draws are deterministic (rates 0 or 1, degenerate ranges).

Interpolation follows ``jax.scipy.ndimage.map_coordinates`` with
``mode="nearest"`` (indices clamped to the volume): order 0 rounds half
AWAY from zero (``lax.round``; ``torch.round`` would round half to even),
order 1 sums the 8 corner terms ``((w0 * w1) * w2) * v`` in JAX's order.

Sample contract (host side, ``train/data.py``):
    image  [PX, PY, PZ] f32, masks [PX, PY, PZ] int32 (pre-crop),
    points [P, 3] f32, ids [P] int32 (0 = padding), center [3] f32.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from skoots_tpu_torch.ops.skeleton import (
    PackedSkeletons,
    bake_skeleton,
    skeleton_to_mask,
)
from skoots_tpu_torch.ops.vec2embed import coordinate_mesh
from skoots_tpu_torch.utils import trace


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, exactly (``x - trunc(x)`` is exact)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def map_coordinates(vol: torch.Tensor, coords: List[torch.Tensor], order: int) -> torch.Tensor:
    """Sample the 3D ``vol`` at flat coordinate arrays ``coords`` (one per
    axis), order 0 or 1, indices clamped to the volume."""
    sizes = vol.shape
    flat = vol.reshape(-1)

    def gather(idx):
        return flat[(idx[0] * sizes[1] + idx[1]) * sizes[2] + idx[2]]

    if order == 0:
        return gather([round_half_away(c).to(torch.int64).clamp(0, s - 1)
                       for c, s in zip(coords, sizes)])
    nodes = []
    for c, s in zip(coords, sizes):
        lower = torch.floor(c)
        wu = c - lower
        wl = 1 - wu
        i = lower.to(torch.int64)
        nodes.append([(i.clamp(0, s - 1), wl), ((i + 1).clamp(0, s - 1), wu)])
    out = None
    for items in itertools.product(*nodes):
        term = ((items[0][1] * items[1][1]) * items[2][1]) * gather([it[0] for it in items])
        out = term if out is None else out + term
    return out


def _warp_volume(vol: torch.Tensor, disp_full: torch.Tensor, order: int) -> torch.Tensor:
    """Sample ``vol`` at (voxel coordinates + ``disp_full`` ``[X, Y, Z, 3]``)."""
    src = coordinate_mesh(vol.shape, device=vol.device) + disp_full
    coords = [src[..., i].reshape(-1) for i in range(3)]
    return map_coordinates(vol, coords, order).reshape(vol.shape)


def _sample_disp_at_points(disp_coarse: torch.Tensor, pts: torch.Tensor, spatial) -> torch.Tensor:
    """Trilinear samples of the coarse ``[gx, gy, gz, 3]`` field at ``[P, 3]``
    voxel coordinates."""
    g = disp_coarse.shape[:3]
    trace.host_sync("augment.elastic_scale_h2d", pts.device)
    scale = torch.tensor([(g[i] - 1) / max(spatial[i] - 1, 1) for i in range(3)],
                         dtype=torch.float32, device=pts.device)
    coords = list((pts * scale).T)
    return torch.stack([map_coordinates(disp_coarse[..., c], coords, 1)
                        for c in range(3)], -1)


def _affine_matrix(angle_deg: float, shear_deg: float, scale: float, center) -> torch.Tensor:
    """Forward in-plane (XY) matrix ``C @ RSS @ C^-1`` (translate 0), f32."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    rot = torch.deg2rad(f(angle_deg))
    sy = torch.deg2rad(f(shear_deg))
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sy) / torch.cos(sy) - torch.sin(rot)
    c_ = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sy) / torch.cos(sy) + torch.cos(rot)
    s = f(scale)
    zero, one = f(0.0), f(1.0)
    rss = torch.stack([torch.stack([a * s, b * s, zero]),
                       torch.stack([c_ * s, d * s, zero]),
                       torch.stack([zero, zero, one])])
    cx, cy = (float(v) for v in center)
    cmat = f([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
    cinv = f([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    return cmat @ rss @ cinv


def make_augment(cfg: dict, dataset_mean: float = 0.0, dataset_std: float = 1.0,
                 intensity_ceiling: float = 255.0) -> Callable:
    """The per-sample augmentation ``fn(sample, gen) -> dict``: ``sample``
    holds device tensors (contract above), ``gen`` is a CPU
    ``torch.Generator``. Output, crop-sized and channels-last: image
    ``[W, H, D, 1]`` f32 normalised, masks ``[W, H, D, 1]`` f32 (binary),
    baked ``[W, H, D, 3]`` f32, skele_masks ``[W, H, D, 1]`` f32."""
    A = cfg["AUGMENTATION"]
    crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
    radius = cfg["TRAIN"]["SKELETON_MASK_RADIUS"]
    flank = cfg["TRAIN"]["SKELETON_MASK_FLANK_RADIUS"]
    anisotropy = tuple(A["BAKE_SKELETON_ANISOTROPY"])
    grid_shape = tuple(A["ELASTIC_GRID_SHAPE"])
    grid_mag = torch.tensor(A["ELASTIC_GRID_MAGNITUDE"], dtype=torch.float32)
    invert_rate = A.get("INVERT_RATE", A["BRIGHTNESS_RATE"])
    ceil = float(intensity_ceiling)

    def uniform(gen, lo, hi) -> float:
        return float(lo) + (float(hi) - float(lo)) * float(torch.rand((), generator=gen))

    def flag(gen, rate) -> bool:
        return bool(torch.rand((), generator=gen) < rate)

    def geometric_core(sample: Dict[str, torch.Tensor], gen: torch.Generator):
        """The spatial + intensity pipeline; returns (image, masks, aux, pts,
        ids). ``sample`` may carry one more volume under ``"aux"`` (sparse
        training's skeleton mask), nearest-interpolated through every
        spatial op as the masks are; aux is None without it."""
        image = sample["image"].float()
        masks = sample["masks"].to(torch.int32)
        aux = sample.get("aux")
        aux = None if aux is None else aux.float()
        pts = sample["points"].float()
        ids = sample["ids"].to(torch.int32)
        trace.host_sync("augment.center_d2h", sample["center"].device)
        center = sample["center"].float().cpu()
        dev = image.device
        spatial = tuple(image.shape)

        # elastic: positive uniform offsets on a coarse grid, trilinearly
        # upsampled; the volume is sampled at (x + d), the points move by -d
        if flag(gen, A["ELASTIC_RATE"]):
            extent = torch.tensor(spatial, dtype=torch.float32)
            disp_coarse = trace.to_device(
                torch.rand((*grid_shape, 3), generator=gen) * grid_mag * (extent / 2.0),
                dev, "augment.elastic_h2d")
            disp_full = F.interpolate(
                disp_coarse.permute(3, 0, 1, 2)[None], size=spatial,
                mode="trilinear", align_corners=False)[0].permute(1, 2, 3, 0)
            image = _warp_volume(image, disp_full, 1)
            masks = _warp_volume(masks.float(), disp_full, 0).to(torch.int32)
            if aux is not None:
                aux = _warp_volume(aux, disp_full, 0)
            pts = pts - _sample_disp_at_points(disp_coarse, pts, spatial)

        # affine, about the pre-crop centre; the crop target follows it
        if flag(gen, A["AFFINE_RATE"]):
            angle = uniform(gen, *A["AFFINE_YAW"])
            shear = uniform(gen, *A["AFFINE_SHEAR"])
            scale = uniform(gen, *A["AFFINE_SCALE"])
            mat = _affine_matrix(angle, shear, scale, (spatial[0] / 2.0, spatial[1] / 2.0))
            inv = trace.to_device(torch.linalg.inv(mat), dev, "augment.affine_h2d")
            mesh = coordinate_mesh(spatial, device=dev)
            xy1 = torch.stack([mesh[..., 0], mesh[..., 1], torch.ones_like(mesh[..., 0])], -1)
            src = xy1 @ inv.T
            coords = [src[..., 0].reshape(-1), src[..., 1].reshape(-1),
                      mesh[..., 2].reshape(-1)]
            image = map_coordinates(image, coords, 1).reshape(spatial)
            masks = map_coordinates(masks.float(), coords, 0).reshape(spatial).to(torch.int32)
            if aux is not None:
                aux = map_coordinates(aux, coords, 0).reshape(spatial)
            mat_d = trace.to_device(mat, dev, "augment.affine_h2d")
            pxy = torch.stack([pts[:, 0], pts[:, 1], torch.ones_like(pts[:, 0])], -1) @ mat_d.T
            pts = torch.stack([pxy[:, 0], pxy[:, 1], pts[:, 2]], -1)
            cxy = mat @ torch.stack([center[0], center[1], torch.tensor(1.0)])
            center = torch.stack([cxy[0], cxy[1], center[2]])

        # crop around the (moved) target
        w = torch.tensor(crop, dtype=torch.float32)
        origin = torch.minimum(torch.clamp(torch.round(center - w / 2.0), min=0.0),
                               torch.tensor(spatial, dtype=torch.float32) - w)
        o = [int(v) for v in origin.to(torch.int64)]
        image = image[o[0]:o[0] + crop[0], o[1]:o[1] + crop[1], o[2]:o[2] + crop[2]]
        masks = masks[o[0]:o[0] + crop[0], o[1]:o[1] + crop[1], o[2]:o[2] + crop[2]]
        if aux is not None:
            aux = aux[o[0]:o[0] + crop[0], o[1]:o[1] + crop[1], o[2]:o[2] + crop[2]]
        trace.host_sync("augment.crop_origin_h2d", dev)
        pts = pts - torch.tensor(o, dtype=torch.float32, device=dev)

        # flips
        for ax in range(3):
            if flag(gen, A["FLIP_RATE"]):
                image = torch.flip(image, (ax,))
                masks = torch.flip(masks, (ax,))
                if aux is not None:
                    aux = torch.flip(aux, (ax,))
                pts = pts.clone()
                pts[:, ax] = (crop[ax] - 1) - pts[:, ax]

        # intensity
        if flag(gen, invert_rate):
            image = ceil - image
        f_b = flag(gen, A["BRIGHTNESS_RATE"])
        bval = uniform(gen, *A["BRIGHTNESS_RANGE"])
        if f_b:
            image = image + bval
        image = image.clamp(0.0, ceil)
        f_c = flag(gen, A["CONTRAST_RATE"])
        cval = uniform(gen, *A["CONTRAST_RANGE"])
        m = image.mean()
        image = ((image - m) * (cval if f_c else 1.0) + m).clamp(0.0, ceil)
        if flag(gen, A["NOISE_RATE"]):
            seed = int(torch.randint(0, 2**62, (), generator=gen))
            dgen = torch.Generator(device=dev).manual_seed(seed)
            image = image + torch.rand(crop, generator=dgen, device=dev) * A["NOISE_GAMMA"]

        norm = sample.get("norm")
        mean, std = (float(norm[0]), float(norm[1])) if norm is not None \
            else (dataset_mean, dataset_std)
        image = (image - mean) / std
        return (image.contiguous(), masks.contiguous(),
                None if aux is None else aux.contiguous(), pts, ids)

    def augment(sample: Dict[str, torch.Tensor], gen: torch.Generator) -> Dict[str, torch.Tensor]:
        image, masks, _, pts, ids = geometric_core(sample, gen)
        skel = PackedSkeletons(points=pts, ids=ids)
        baked = bake_skeleton(masks, skel, anisotropy=anisotropy)
        skele_mask = skeleton_to_mask(skel, crop, radius=radius, flank_radius=flank)
        return {
            "image": image[..., None],
            "masks": (masks > 0).float()[..., None],
            "baked": baked,
            "skele_masks": skele_mask[..., None],
        }

    augment.geometric_core = geometric_core
    return augment


def make_batch_augment(cfg: dict, dataset_mean: float = 0.0, dataset_std: float = 1.0,
                       intensity_ceiling: float = 255.0, device=None) -> Callable:
    """``fn(host_batch, gen) -> batch``: moves a stacked numpy host batch
    (``train/data.py::batch_iterator``) to ``device`` (the crop centre stays
    on the host, where the crop origin is computed), augments each sample
    and stacks the results ``[B, W, H, D, C]``; a call is the span
    ``train.augment``."""
    aug = make_augment(cfg, intensity_ceiling=intensity_ceiling)
    norm = (float(dataset_mean), float(dataset_std))

    @trace.spanned("train.augment")
    def batch_aug(host_batch: Dict[str, np.ndarray], gen: torch.Generator):
        b = host_batch["image"].shape[0]
        outs = []
        for i in range(b):
            sample = {k: torch.from_numpy(np.ascontiguousarray(v[i]))
                      for k, v in host_batch.items()}
            sample = {k: v if k == "center" else trace.to_device(v, device, "augment.sample_h2d")
                      for k, v in sample.items()}
            sample["norm"] = norm
            outs.append(aug(sample, gen))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return batch_aug
