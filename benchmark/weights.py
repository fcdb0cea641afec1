"""Model weights from the seed, made on the card in one call.

flax's initialisation, as the program's ``init_parameters`` states it: every
kernel lecun-normal (a normal truncated to two standard deviations, scaled
to variance 1 / fan-in, fan-in the product of all but the kernel's output
axis), biases 0, norm scales 1, the layer scale its configured value. The
draws differ from the program's own initialiser: one
``torch.nn.init.trunc_normal_`` over a flat buffer from a generator on the
device, seeded from ``--seed``, then cut into leaves. The same dict goes to
the program (copied into its parameters) and to the reference.
"""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def make(shapes: dict, seed: int, layer_scale: float, device) -> dict:
    """``{name: f32 tensor}`` for the ``{name: shape}`` of a model's
    parameters (named as its ``state_dict``)."""
    kernels = [n for n in shapes if _kind(n) == "kernel"]
    total = sum(math.prod(shapes[n]) for n in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for n in shapes:
        shape = tuple(shapes[n])
        kind = _kind(n)
        if kind == "kernel":
            size = math.prod(shape)
            fan_in = math.prod(shape[:-1])
            out[n] = flat[at:at + size].view(shape) * (math.sqrt(1.0 / fan_in) / TRUNC_STD)
            at += size
        elif kind == "scale":
            out[n] = torch.ones(shape, device=device)
        elif kind == "gamma":
            out[n] = torch.full(shape, float(layer_scale), device=device)
        else:
            out[n] = torch.zeros(shape, device=device)
    return out


def _kind(name: str) -> str:
    owner, leaf = name.rsplit(".", 1)
    last = owner.rsplit(".", 1)[-1]
    if leaf == "gamma":
        return "gamma"
    if leaf == "bias":
        return "bias"
    if last in ("norm", "final_norm") or "_gn" in last:
        return "scale"
    return "kernel"
