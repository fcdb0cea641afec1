"""Plain f32 reference of the dense SKOOTS training step, from the raw
records to the parameters after the update.

It follows the published step (buswinka/skoots ``train.py`` with its
dataloader and transforms) as the program draws its randomness, so the same
seed gives the same batches: the host sampler (a skeleton-centred pre-crop of
crop + 300 in XY, points within 50 voxels of it, at most
``MAX_SKELETON_POINTS`` kept by ``rng.choice``), drawn from
``numpy.random.default_rng(seed + epoch * 7919)``; the augmentation on the
card, its scalar draws from a CPU ``torch.Generator`` seeded ``seed +
epoch`` (elastic warp on a 6x6x2 grid, in-plane affine, crop about the
target, flips, invert, brightness, contrast, noise from a card generator
seeded from it, normalisation); the bake (each foreground voxel's nearest
skeleton point of its own instance under the anisotropy, first minimum on
ties, then the 3^3 mean of the nonzero entries) and the skeleton-mask stamp;
the model (``reference/model.py``) in f32; the embedding ``vector * scale +
position``, its Gaussian against the baked skeleton at the epoch's sigma;
three Tversky losses gated by their start epochs; autograd; AdamW at the
epoch's cosine-restart learning rate. The code below is a frozen copy of the
program's plain host and augmentation code where the two must draw alike;
the model, the losses and the optimizer are written anew.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref_model


# ---- host sampler -------------------------------------------------------

def mean_std(records, with_invert: bool):
    total, total_sq, n, mx = 0.0, 0.0, 0, 0.0
    for r in records:
        total += float(r["image"].sum())
        total_sq += float((r["image"].astype(np.float64) ** 2).sum())
        n += r["image"].size
        mx = max(mx, float(r["image"].max()))
    if with_invert:
        ceil = 255.0 if mx <= 255.0 else 65535.0
        total_sq = 2 * total_sq + n * ceil**2 - 2 * ceil * total
        total = n * ceil
        n *= 2
    mean = total / n
    return mean, max((total_sq / n - mean**2), 1e-8) ** 0.5


def sample(records, cfg, rng):
    A = cfg["AUGMENTATION"]
    crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
    pre = (crop[0] + 300, crop[1] + 300, crop[2])
    vol_min = np.min([r["image"].shape for r in records], axis=0)
    pre = tuple(max(c, min(p, int(v))) for p, c, v in zip(pre, crop, vol_min))
    max_points = cfg["TRAIN"]["MAX_SKELETON_POINTS"]
    rec = records[rng.integers(len(records))]
    shape = rec["image"].shape
    pre_v = tuple(min(p, s) for p, s in zip(pre, shape))
    skel = rec["skeletons"]
    key = list(skel.keys())[rng.integers(len(skel))]
    center = skel[key].mean(axis=0)
    origin = np.clip(np.round(center - np.asarray(pre_v) / 2).astype(np.int64), 0,
                     np.asarray(shape) - np.asarray(pre_v))
    sl = tuple(slice(o, o + p) for o, p in zip(origin, pre_v))
    image, masks = rec["image"][sl], rec["masks"][sl]
    pts = np.zeros((max_points, 3), np.float32)
    ids = np.zeros((max_points,), np.int32)
    allp = np.concatenate([v - origin[None, :] for v in skel.values()])
    alli = np.concatenate([np.full(len(v), k, np.int32) for k, v in skel.items()])
    inside = np.all((allp > -50) & (allp < np.asarray(pre) + 50), axis=1)
    allp, alli = allp[inside], alli[inside]
    if len(allp) > max_points:
        sel = rng.choice(len(allp), max_points, replace=False)
        allp, alli = allp[sel], alli[sel]
    pts[:len(allp)] = allp
    ids[:len(alli)] = alli
    return {"image": image.astype(np.float32), "masks": masks.astype(np.int32),
            "points": pts, "ids": ids, "center": (center - origin).astype(np.float32)}


# ---- augmentation (frozen copy of the program's plain code) --------------

def _round_half_away(x):
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def map_coordinates(vol, coords, order):
    sizes = vol.shape
    flat = vol.reshape(-1)

    def gather(idx):
        return flat[(idx[0] * sizes[1] + idx[1]) * sizes[2] + idx[2]]

    if order == 0:
        return gather([_round_half_away(c).to(torch.int64).clamp(0, s - 1)
                       for c, s in zip(coords, sizes)])
    nodes = []
    for c, s in zip(coords, sizes):
        lower = torch.floor(c)
        wu = c - lower
        i = lower.to(torch.int64)
        nodes.append([(i.clamp(0, s - 1), 1 - wu), ((i + 1).clamp(0, s - 1), wu)])
    out = None
    for items in itertools.product(*nodes):
        term = ((items[0][1] * items[1][1]) * items[2][1]) * gather([it[0] for it in items])
        out = term if out is None else out + term
    return out


def mesh(shape, device):
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def _affine(angle_deg, shear_deg, scale, center):
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    rot, sy = torch.deg2rad(f(angle_deg)), torch.deg2rad(f(shear_deg))
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sy) / torch.cos(sy) - torch.sin(rot)
    c_ = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sy) / torch.cos(sy) + torch.cos(rot)
    s, zero, one = f(scale), f(0.0), f(1.0)
    rss = torch.stack([torch.stack([a * s, b * s, zero]), torch.stack([c_ * s, d * s, zero]),
                       torch.stack([zero, zero, one])])
    cx, cy = (float(v) for v in center)
    cmat = f([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
    cinv = f([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    return cmat @ rss @ cinv


def augment(s, cfg, gen, mean, std, ceil, device):
    A = cfg["AUGMENTATION"]
    crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
    invert_rate = A.get("INVERT_RATE", A["BRIGHTNESS_RATE"])

    def uniform(lo, hi):
        return float(lo) + (float(hi) - float(lo)) * float(torch.rand((), generator=gen))

    def flag(rate):
        return bool(torch.rand((), generator=gen) < rate)

    image = torch.from_numpy(s["image"]).to(device)
    masks = torch.from_numpy(s["masks"]).to(device)
    pts = torch.from_numpy(s["points"]).to(device)
    ids = torch.from_numpy(s["ids"]).to(device)
    center = torch.from_numpy(s["center"]).float()
    spatial = tuple(image.shape)
    if flag(A["ELASTIC_RATE"]):
        extent = torch.tensor(spatial, dtype=torch.float32)
        grid = tuple(A["ELASTIC_GRID_SHAPE"])
        mag = torch.tensor(A["ELASTIC_GRID_MAGNITUDE"], dtype=torch.float32)
        dc = (torch.rand((*grid, 3), generator=gen) * mag * (extent / 2.0)).to(device)
        df = F.interpolate(dc.permute(3, 0, 1, 2)[None], size=spatial, mode="trilinear",
                           align_corners=False)[0].permute(1, 2, 3, 0)
        src = mesh(spatial, device) + df
        co = [src[..., i].reshape(-1) for i in range(3)]
        image = map_coordinates(image, co, 1).reshape(spatial)
        masks = map_coordinates(masks.float(), co, 0).reshape(spatial).to(torch.int32)
        sc = torch.tensor([(grid[i] - 1) / max(spatial[i] - 1, 1) for i in range(3)],
                          dtype=torch.float32, device=device)
        pc = list((pts * sc).T)
        pts = pts - torch.stack([map_coordinates(dc[..., c], pc, 1) for c in range(3)], -1)
    if flag(A["AFFINE_RATE"]):
        mat = _affine(uniform(*A["AFFINE_YAW"]), uniform(*A["AFFINE_SHEAR"]),
                      uniform(*A["AFFINE_SCALE"]), (spatial[0] / 2.0, spatial[1] / 2.0))
        inv = torch.linalg.inv(mat).to(device)
        m = mesh(spatial, device)
        xy1 = torch.stack([m[..., 0], m[..., 1], torch.ones_like(m[..., 0])], -1)
        src = xy1 @ inv.T
        co = [src[..., 0].reshape(-1), src[..., 1].reshape(-1), m[..., 2].reshape(-1)]
        image = map_coordinates(image, co, 1).reshape(spatial)
        masks = map_coordinates(masks.float(), co, 0).reshape(spatial).to(torch.int32)
        md = mat.to(device)
        pxy = torch.stack([pts[:, 0], pts[:, 1], torch.ones_like(pts[:, 0])], -1) @ md.T
        pts = torch.stack([pxy[:, 0], pxy[:, 1], pts[:, 2]], -1)
        cxy = mat @ torch.stack([center[0], center[1], torch.tensor(1.0)])
        center = torch.stack([cxy[0], cxy[1], center[2]])
    w = torch.tensor(crop, dtype=torch.float32)
    origin = torch.minimum(torch.clamp(torch.round(center - w / 2.0), min=0.0),
                           torch.tensor(spatial, dtype=torch.float32) - w)
    o = [int(v) for v in origin.to(torch.int64)]
    sl = tuple(slice(a, a + c) for a, c in zip(o, crop))
    image, masks = image[sl], masks[sl]
    pts = pts - torch.tensor(o, dtype=torch.float32, device=device)
    for ax in range(3):
        if flag(A["FLIP_RATE"]):
            image, masks = torch.flip(image, (ax,)), torch.flip(masks, (ax,))
            pts = pts.clone()
            pts[:, ax] = (crop[ax] - 1) - pts[:, ax]
    if flag(invert_rate):
        image = ceil - image
    f_b = flag(A["BRIGHTNESS_RATE"])
    bval = uniform(*A["BRIGHTNESS_RANGE"])
    if f_b:
        image = image + bval
    image = image.clamp(0.0, ceil)
    f_c = flag(A["CONTRAST_RATE"])
    cval = uniform(*A["CONTRAST_RANGE"])
    mu = image.mean()
    image = ((image - mu) * (cval if f_c else 1.0) + mu).clamp(0.0, ceil)
    if flag(A["NOISE_RATE"]):
        nseed = int(torch.randint(0, 2**62, (), generator=gen))
        dgen = torch.Generator(device=device).manual_seed(nseed)
        image = image + torch.rand(crop, generator=dgen, device=device) * A["NOISE_GAMMA"]
    image = (image - mean) / std
    baked = bake(masks, pts, ids, tuple(A["BAKE_SKELETON_ANISOTROPY"]))
    skm = skeleton_mask(pts, ids, crop, cfg["TRAIN"]["SKELETON_MASK_RADIUS"],
                        cfg["TRAIN"]["SKELETON_MASK_FLANK_RADIUS"])
    return {"image": image[..., None], "masks": (masks > 0).float()[..., None],
            "baked": baked, "skele_masks": skm[..., None]}


def bake(masks, pts, ids, aniso, chunk: int = 65536):
    """Per foreground voxel, its own instance's nearest point (first on
    ties), then the 3^3 mean of the nonzero entries."""
    shape = tuple(masks.shape)
    dev = masks.device
    flat = masks.reshape(-1)
    sel = torch.nonzero(flat > 0)[:, 0]
    coords = mesh(shape, dev).reshape(-1, 3)
    out = torch.zeros((flat.numel(), 3), dtype=torch.float32, device=dev)
    w = [float(a) for a in aniso]
    for s0 in range(0, len(sel), chunk):
        i = sel[s0:s0 + chunk]
        c, m = coords[i], flat[i]
        d2 = ((c[:, 0:1] - pts[None, :, 0]) ** 2 * w[0] + (c[:, 1:2] - pts[None, :, 1]) ** 2
              * w[1] + (c[:, 2:3] - pts[None, :, 2]) ** 2 * w[2])
        valid = (ids[None, :] == m[:, None]) & (ids[None, :] != 0)
        d2 = torch.where(valid, d2, torch.full_like(d2, 3.0e38))
        best = torch.argmin(d2, dim=1)
        found = torch.gather(d2, 1, best[:, None])[:, 0] < 3.0e38
        out[i] = torch.where(found[:, None], pts[best], 0.0)
    b = out.reshape(1, *shape, 3)
    total = _window_sum(b, 3)
    count = _window_sum((b > 0).float(), 3)
    return (total / count.clamp_min(1.0))[0]


def _window_sum(t, k):
    h = k // 2
    for ax in (1, 2, 3):
        n = t.shape[ax]
        tp = F.pad(t, [0, 0] * (t.ndim - ax - 1) + [h, h])
        s = tp.narrow(ax, 0, n)
        for d in range(1, k):
            s = s + tp.narrow(ax, d, n)
        t = s
    return t


def skeleton_mask(pts, ids, shape, radius, flank):
    def disk(r):
        g = np.arange(-r, r + 1)
        xx, yy = np.meshgrid(g, g, indexing="ij")
        return (xx * xx + yy * yy) <= r * r

    total = np.stack((np.pad(disk(flank), radius - flank), disk(radius),
                      np.pad(disk(flank), radius - flank)), axis=-1)
    offs = np.argwhere(total).astype(np.int64)
    offs -= np.array([radius, radius, 1])
    dev = pts.device
    co = (torch.round(pts).long()[:, None, :] + torch.from_numpy(offs).to(dev)[None]).reshape(-1, 3)
    valid = (ids != 0)[:, None].expand(-1, offs.shape[0]).reshape(-1)
    lim = torch.tensor(shape, dtype=torch.int64, device=dev)
    co = torch.where(co < 0, co + lim, co)
    valid = valid & ((co >= 0) & (co < lim)).all(-1)
    co = co[valid]
    m = torch.zeros(shape, dtype=torch.float32, device=dev)
    m[co[:, 0], co[:, 1], co[:, 2]] = 1.0
    return m


# ---- model, loss, optimizer --------------------------------------------

def tversky(alpha, beta, eps):
    def fn(p, g):
        p, g = p.reshape(p.shape[0], -1), g.reshape(g.shape[0], -1)
        tp = (p * g).sum(1)
        fp = ((p * (1.0 - g)).sum(1) + 1e-10) * alpha
        fn_ = ((1.0 - p) * g).sum(1) * beta
        return (1.0 - (tp + eps) / (tp + fp + fn_ + eps)).mean()
    return fn


def sigma(cfg, epoch):
    t = cfg["TRAIN"]
    mult = np.float32(1.0)
    for m, e in t["SIGMA_DECAY"]:
        if e < epoch:
            mult = np.float32(mult * np.float32(m))
    return np.asarray(t["INITIAL_SIGMA"], np.float32) * mult


def learning_rate(cfg, epoch):
    t = cfg["TRAIN"]
    lr = float(t["LEARNING_RATE"])
    if t["SCHEDULER"] != "cosine_annealing_warm_restarts":
        return lr
    f32 = np.float32
    e = f32(epoch % int(t["SCHEDULER_T0"]))
    return float(f32(lr) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * e / f32(t["SCHEDULER_T0"]))))


def loss(params, cfg, batch, epoch, q=None):
    t = cfg["TRAIN"]
    out = ref_model.forward(params, cfg["MODEL"], batch["image"], q)
    vec, skel, prob = out[..., 0:3], out[..., 3:4], out[..., 4:5]
    scale = torch.tensor([float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"]],
                         device=vec.device)
    emb = vec * scale + mesh(vec.shape[1:4], vec.device)[None]
    sg = torch.as_tensor(sigma(cfg, epoch), device=vec.device) + 1e-16
    eprob = torch.exp(((emb - batch["baked"]) ** 2 / (sg * sg * -2.0)).sum(-1, keepdim=True))
    gt_fg, gt_sk = (batch["masks"] > 0).float(), (batch["skele_masks"] > 0).float()
    terms = []
    for name, pred, gt in (("EMBED", eprob, gt_fg), ("PROBABILITY", prob, gt_fg),
                           ("SKELETON", skel, gt_sk)):
        kw = dict(zip(t[f"LOSS_{name}_KEYWORDS"], t[f"LOSS_{name}_VALUES"]))
        if t[f"LOSS_{name}"] != "tversky":
            raise ValueError(f"the reference has tversky only, not {t[f'LOSS_{name}']}")
        on = float(epoch > t[f"LOSS_{name}_START_EPOCH"])
        terms.append(t[f"LOSS_{name}_RELATIVE_WEIGHT"] * on
                     * tversky(kw["alpha"], kw["beta"], kw["eps"])(pred, gt))
    return sum(terms)


def replay(records, cfg, seed, epoch, params0, steps, device, q=None):
    """The first ``steps`` steps from ``params0``: ``{'losses': [...],
    'grad1': {name: tensor}, 'params': {name: tensor}}`` (the gradient of
    step 1, the parameters after the last step)."""
    ref_model.no_tf32()
    A = cfg["AUGMENTATION"]
    mean, std = mean_std(records, A.get("INVERT_RATE", A["BRIGHTNESS_RATE"]) > 0)
    ceil = 255.0 if max(float(r["image"].max()) for r in records) <= 255.0 else 65535.0
    rng = np.random.default_rng(seed + epoch * 7919)
    gen = torch.Generator().manual_seed(seed + epoch)
    params = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in params0.items()}
    t = cfg["TRAIN"]
    opt = torch.optim.AdamW(list(params.values()), lr=learning_rate(cfg, epoch),
                            weight_decay=float(t["WEIGHT_DECAY"]), eps=float(t["OPTIMIZER_EPS"]))
    bsz = int(t["TRAIN_BATCH_SIZE"])
    losses, grad1 = [], None
    for i in range(steps):
        samples = []
        for _ in range(bsz):
            rng.choice(1, p=np.ones(1))  # the training CLI's MultiDataset draws its source
            samples.append(sample(records, cfg, rng))
        outs = [augment(s, cfg, gen, mean, std, ceil, device) for s in samples]
        batch = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        opt.zero_grad(set_to_none=True)
        total = loss(params, cfg, batch, epoch, q)
        total.backward()
        if i == 0:
            grad1 = {k: v.grad.detach().clone() for k, v in params.items()}
        opt.step()
        losses.append(float(total.detach()))
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.detach().clone() for k, v in params.items()}}


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    rn = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return {k: abs(float(prog[k].float().norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in keep}


def leaf_diffs(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's norm of the difference between the program and the
    reference, over the larger of the reference's norm of that leaf and of
    the median leaf: unlike :func:`leaf_gaps`, it sees a direction gone
    wrong (a sign flipped, entries permuted)."""
    rn = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return {k: float((prog[k].float() - ref[k].float()).norm()) / max(rn[k], med, 1e-30)
            for k in keep}


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def moved_leaves(grad1: dict) -> list:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's norm (the rest move under Adam by round-off alone)."""
    norms = {k: float(v.norm()) for k, v in grad1.items()}
    med = float(np.median(list(norms.values())))
    return sorted(k for k, n in norms.items() if n > 1e-3 * med)
