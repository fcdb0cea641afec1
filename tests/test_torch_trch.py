"""The port's ``.trch`` import (``skoots_tpu_torch/utils/torch_compat.py``)
against the JAX package's converter, on the CPU.

The reference checkpoints come from a torch twin of the reference UNeXT
(its constructor copied from ``tests/test_compat.py``: stem, encoder stages with
downsamples, bottleneck, skip fusions and decoder stages, final norm and
head, three output heads, in bism's registration order) with every tensor
randomised, and from a state dict in the upstream-ConvNeXt naming with a
value tag a tensor. Both are converted by both packages: the ``.skoots``
parameters are bit for bit equal, and so are the ``extra`` lists; each
package's loader reads the other's file; the port's f32 forward from the
converted file equals the twin's forward within 2e-5; ``export_torch_state``
inverts the import exactly; the LCS alignment and the no-cfg legacy file
behave as JAX's tests check.
"""

import jax
import numpy as np
import pytest
import torch

from skoots_tpu.config import cfg_from_dict as jax_cfg_from_dict
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.checkpoint import restore_params as jax_restore_params
from skoots_tpu.utils import torch_compat as J
from skoots_tpu_torch.config import CfgNode, cfg_from_dict
from skoots_tpu_torch.models import cfg_to_model, model_from_checkpoint
from skoots_tpu_torch.train.checkpoint import load_checkpoint, restore_params
from skoots_tpu_torch.utils import torch_compat as T

TWIN_CFG = {"MODEL": {"DIMS": [4, 8, 4], "DEPTHS": [2, 1, 2], "IN_CHANNELS": 1,
                      "OUT_CHANNELS": 8, "DTYPE": "float32"}}
CONVNEXT_CFG = {"MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1],
                          "IN_CHANNELS": 1, "OUT_CHANNELS": 4, "KERNEL_SIZE": 3,
                          "DTYPE": "float32"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build_torch_twin(torch, dims, depths, in_channels, out_channels, k=7):
    """A torch UNeXT twin mirroring the presumed bism registration order
    (stem -> enc stages + downsamples -> bottleneck -> skip-fuse + dec
    stages -> final norm/head -> 3 output heads). Used to validate the
    order-based .trch weight mapper at value level."""
    nn = torch.nn
    F = torch.nn.functional

    class Block(nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.dwconv = nn.Conv3d(dim, dim, k, padding=k // 2, groups=dim)
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            self.pwconv1 = nn.Linear(dim, 4 * dim)
            self.act = nn.GELU()
            self.pwconv2 = nn.Linear(4 * dim, dim)
            self.gamma = nn.Parameter(torch.ones(dim))

        def forward(self, x):  # [B, C, X, Y, Z]
            inp = x
            x = self.dwconv(x)
            x = x.permute(0, 2, 3, 4, 1)
            x = self.pwconv2(self.act(self.pwconv1(self.norm(x))))
            x = self.gamma * x
            return inp + x.permute(0, 4, 1, 2, 3)

    class LayerNormCF(nn.Module):  # channels-first LayerNorm
        def __init__(self, dim):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

        def forward(self, x):
            u = x.mean(1, keepdim=True)
            s = (x - u).pow(2).mean(1, keepdim=True)
            x = (x - u) / torch.sqrt(s + 1e-6)
            return self.weight[:, None, None, None] * x + self.bias[:, None, None, None]

    class Down(nn.Module):
        def __init__(self, din, dout):
            super().__init__()
            self.norm = LayerNormCF(din)
            self.conv = nn.Conv3d(din, dout, 2, stride=2)

        def forward(self, x):
            return self.conv(self.norm(x))

    class Twin(nn.Module):
        def __init__(self):
            super().__init__()
            kd = len(dims) // 2
            self.stem = nn.Conv3d(in_channels, dims[0], k, padding=k // 2)
            self.enc = nn.ModuleList()
            for s in range(kd):
                self.enc.append(nn.Sequential(
                    *[Block(dims[s]) for _ in range(depths[s])],
                    Down(dims[s], dims[s + 1]),
                ))
            self.bottleneck = nn.Sequential(
                *[Block(dims[kd]) for _ in range(depths[kd])])
            self.dec = nn.ModuleList()
            for s in range(kd):
                d = kd + 1 + s
                self.dec.append(nn.ModuleDict({
                    "fuse": nn.Conv3d(dims[d - 1] + dims[kd - 1 - s], dims[d], 1),
                    "blocks": nn.Sequential(
                        *[Block(dims[d]) for _ in range(depths[d])]),
                }))
            self.final_norm = LayerNormCF(dims[-1])
            self.head_conv = nn.Conv3d(dims[-1], out_channels, 1)
            self.vector = nn.Conv3d(out_channels, 3, 1)
            self.skeleton = nn.Conv3d(out_channels, 1, 1)
            self.semantic = nn.Conv3d(out_channels, 1, 1)

        def forward(self, x):
            kd = len(dims) // 2
            skips = []
            x = self.stem(x)
            for s in range(kd):
                for m in self.enc[s][:-1]:
                    x = m(x)
                skips.append(x)
                x = self.enc[s][-1](x)
            x = self.bottleneck(x)
            for s in range(kd):
                x = F.interpolate(x, scale_factor=2, mode="trilinear",
                                  align_corners=False)
                x = self.dec[s]["fuse"](torch.cat([x, skips[kd - 1 - s]], 1))
                x = self.dec[s]["blocks"](x)
            x = self.head_conv(self.final_norm(x))
            return torch.cat([torch.tanh(self.vector(x)),
                              torch.sigmoid(self.skeleton(x)),
                              torch.sigmoid(self.semantic(x))], 1)

    return Twin()


def _convnext_state():
    """State dict in ConvNeXt registration order, every tensor filled
    with a unique constant tag. dims [4,8,16,8,4], depths [1]*5, k=3."""
    entries = [
        # stem Sequential: conv + channels-first LayerNorm (the LN has no
        # flax counterpart and must surface as unmapped, never guessed)
        ("backbone.downsample_layers.0.0.weight", (4, 1, 3, 3, 3)),
        ("backbone.downsample_layers.0.0.bias", (4,)),
        ("backbone.downsample_layers.0.1.weight", (4,)),
        ("backbone.downsample_layers.0.1.bias", (4,)),
        # downsamples: LN + strided conv
        ("backbone.downsample_layers.1.0.weight", (4,)),
        ("backbone.downsample_layers.1.0.bias", (4,)),
        ("backbone.downsample_layers.1.1.weight", (8, 4, 2, 2, 2)),
        ("backbone.downsample_layers.1.1.bias", (8,)),
        ("backbone.downsample_layers.2.0.weight", (8,)),
        ("backbone.downsample_layers.2.0.bias", (8,)),
        ("backbone.downsample_layers.2.1.weight", (16, 8, 2, 2, 2)),
        ("backbone.downsample_layers.2.1.bias", (16,)),
    ]
    for s, dim in enumerate([4, 8, 16, 8, 4]):
        p = f"backbone.stages.{s}.0."
        entries += [
            (p + "gamma", (dim,)),
            (p + "dwconv.weight", (dim, 1, 3, 3, 3)),
            (p + "dwconv.bias", (dim,)),
            (p + "norm.weight", (dim,)),
            (p + "norm.bias", (dim,)),
            (p + "pwconv1.weight", (4 * dim, dim)),
            (p + "pwconv1.bias", (4 * dim,)),
            (p + "pwconv2.weight", (dim, 4 * dim)),
            (p + "pwconv2.bias", (dim,)),
        ]
    entries += [
        ("backbone.concat.0.conv.weight", (8, 24, 1, 1, 1)),
        ("backbone.concat.0.conv.bias", (8,)),
        ("backbone.concat.1.conv.weight", (4, 12, 1, 1, 1)),
        ("backbone.concat.1.conv.bias", (4,)),
        ("backbone.norm.weight", (4,)),
        ("backbone.norm.bias", (4,)),
        ("backbone.head.weight", (4, 4, 1, 1, 1)),
        ("backbone.head.bias", (4,)),
        ("vector_predictor.weight", (3, 4, 1, 1, 1)),
        ("vector_predictor.bias", (3,)),
        ("skeleton_predictor.weight", (1, 4, 1, 1, 1)),
        ("skeleton_predictor.bias", (1,)),
        ("semantic_predictor.weight", (1, 4, 1, 1, 1)),
        ("semantic_predictor.bias", (1,)),
    ]
    state = {}
    tags = {}
    for i, (k, shape) in enumerate(entries):
        tags[k] = float(i + 1)
        state[k] = np.full(shape, tags[k], np.float32)
    return state, tags


def _twin(seed: int):
    """The twin at ``TWIN_CFG`` with every parameter drawn from ``seed``
    (default-initialised norms and convs would hide mapping errors behind
    identical constants)."""
    torch.manual_seed(seed)
    twin = _build_torch_twin(torch, TWIN_CFG["MODEL"]["DIMS"], TWIN_CFG["MODEL"]["DEPTHS"],
                             1, 8)
    with torch.no_grad():
        for p in twin.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
    return twin


def _numpy_state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _leaves(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _write_trch(tmp_path, name, cfg, state, mean=41.5, std=12.25):
    path = str(tmp_path / f"{name}.trch")
    torch.save({"cfg": cfg, "model_state_dict": state, "optimizer_state_dict": {},
                "dataset_mean": mean, "dataset_std": std}, path)
    return path


@pytest.mark.parametrize("case", ["twin", "convnext_names"])
def test_convert_trch_matches_jax(tmp_path, case):
    """Both converters on one reference file: parameters bit for bit equal,
    the same ``extra`` lists, cfg and dataset stats; JAX's loader and
    ``restore_params`` read the port's file, the port's reads JAX's."""
    if case == "twin":
        cfg = TWIN_CFG
        state = {k: torch.from_numpy(v) for k, v in _numpy_state(_twin(7)).items()}
    else:
        cfg = CONVNEXT_CFG
        state = {k: torch.from_numpy(v) for k, v in _convnext_state()[0].items()}
    src = _write_trch(tmp_path, case, cfg, state)
    ours = T.convert_trch(src, str(tmp_path / "port.skoots"))
    theirs = J.convert_trch(src, str(tmp_path / "jax.skoots"))
    a, b = load_checkpoint(ours), load_checkpoint(theirs)
    assert isinstance(a["cfg"], CfgNode) and a["cfg"].MODEL.DIMS == cfg["MODEL"]["DIMS"]
    assert a["cfg"] == b["cfg"] and (a["dataset_mean"], a["dataset_std"]) == (41.5, 12.25)
    for key in ("mapped", "unmapped_torch_keys", "unfilled_params", "torch_state_dict_keys"):
        assert a["extra"][key] == b["extra"][key], key
    assert a["extra"]["converted_from"] == b["extra"]["converted_from"] == src
    assert a["extra"]["unfilled_params"] == []
    if case == "twin":
        assert a["extra"]["unmapped_torch_keys"] == [] and a["extra"]["mapped"] == len(state)
    else:  # the stem's LayerNorm has no counterpart, in both packages
        assert a["extra"]["unmapped_torch_keys"] == [
            "backbone.downsample_layers.0.1.bias", "backbone.downsample_layers.0.1.weight"]
    la, lb = _leaves(a["params"]), _leaves(b["params"])
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.float32, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))

    jc = jax_load_checkpoint(ours)
    _, tmpl = jax_init_model(jax_cfg_from_dict(cfg), jax.random.PRNGKey(0),
                             spatial=(8, 8, 8))
    restored = _leaves(jax.tree_util.tree_map(np.asarray,
                                              jax_restore_params(tmpl, jc["params"])))
    for k, v in restored.items():
        np.testing.assert_array_equal(v, lb[k], err_msg="/".join(k))
    assert jc["cfg"].MODEL.DIMS == cfg["MODEL"]["DIMS"] and jc["dataset_std"] == 12.25
    model = restore_params(cfg_to_model(b["cfg"], device="cpu"), b["params"])
    mine = model_from_checkpoint(a, device="cpu").state_dict()
    assert all(torch.equal(p, mine[n]) for n, p in model.state_dict().items())


def test_converted_forward_matches_the_twin(tmp_path):
    """The port's f32 model from the converted file computes the twin's
    output (channels-last against channels-first) within 2e-5."""
    twin = _twin(3)
    src = _write_trch(tmp_path, "twin", TWIN_CFG, twin.state_dict())
    model = model_from_checkpoint(load_checkpoint(T.convert_trch(src)), device="cpu")
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 8, 1)).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(x.transpose(0, 4, 1, 2, 3))).numpy().transpose(0, 2, 3, 4, 1)
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_export_roundtrip():
    """flax -> torch export inverts the torch -> flax import exactly, and
    the port's import equals JAX's leaf for leaf."""
    cfg = cfg_from_dict(TWIN_CFG)
    state = _numpy_state(_twin(11))
    from skoots_tpu_torch.checkpoint import flax_params_from_torch
    from skoots_tpu_torch.models import init_model

    params = flax_params_from_torch(init_model(cfg, 0, device="cpu").state_dict())
    params, mapped, unmapped, unfilled = T.map_torch_state(params, state, cfg)
    assert (mapped, unmapped, unfilled) == (len(state), [], [])
    jcfg = jax_cfg_from_dict(TWIN_CFG)
    _, jparams = jax_init_model(jcfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    jparams = J.map_torch_state(jparams, state, jcfg)[0]
    mine, ref = _leaves(params), _leaves(jax.tree_util.tree_map(np.asarray, jparams))
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg="/".join(k))

    template = {k: np.zeros_like(v) for k, v in state.items()}
    out, exported, skipped, unused = T.export_torch_state(params, template, cfg)
    assert (exported, skipped, unused) == (len(state), [], [])
    for k in state:
        np.testing.assert_array_equal(out[k], state[k], err_msg=k)
    want = J.export_torch_state(jparams, template, jcfg)
    assert want[1:] == (exported, skipped, unused)


def test_lcs_alignment_tolerates_extra_buffers():
    """An integer buffer is dropped and one stray tensor stays unmapped;
    every parameter is still filled, as in JAX."""
    cfg = cfg_from_dict(TWIN_CFG)
    state = _numpy_state(_twin(1))
    state["num_batches_tracked"] = np.zeros((), np.int64)
    state["some.extra.tensor"] = np.zeros((13, 17), np.float32)
    from skoots_tpu_torch.checkpoint import flax_params_from_torch
    from skoots_tpu_torch.models import init_model

    params = flax_params_from_torch(init_model(cfg, 0, device="cpu").state_dict())
    _, mapped, unmapped, unfilled = T.map_torch_state(params, state, cfg)
    assert unmapped == ["some.extra.tensor"] and unfilled == []
    jcfg = jax_cfg_from_dict(TWIN_CFG)
    _, jparams = jax_init_model(jcfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    assert J.map_torch_state(jparams, state, jcfg)[1:] == (mapped, unmapped, unfilled)


@pytest.mark.parametrize("key", [
    "backbone.downsample_layers.0.0.weight", "backbone.downsample_layers.0.1.bias",
    "backbone.downsample_layers.2.1.weight", "backbone.stages.2.0.gamma",
    "backbone.stages.4.0.pwconv1.bias", "backbone.up_stages.1.0.dwconv.weight",
    "module.backbone.stages.0.blocks.0.norm.weight", "backbone.concat.1.conv.weight",
    "backbone.norm.bias", "backbone.head.weight", "vector_predictor.bias",
    "skeleton_out.weight", "semantic_predictor.weight", "backbone.stem.weight",
    "backbone.init_conv.conv.bias", "model._orig_mod.stages.9.0.dwconv.weight",
    "some.unknown.key"])
def test_role_from_torch_key_matches_jax(key):
    assert T.role_from_torch_key(key, cfg_from_dict(CONVNEXT_CFG)) == \
        J.role_from_torch_key(key, jax_cfg_from_dict(CONVNEXT_CFG))


def test_ordered_roles_match_jax():
    for d in (TWIN_CFG, CONVNEXT_CFG):
        assert T.ordered_flax_roles(cfg_from_dict(d)) == J.ordered_flax_roles(jax_cfg_from_dict(d))
    bad = {"MODEL": {"ARCHITECTURE": "bism_unet"}}
    with pytest.raises(NotImplementedError):
        T.ordered_flax_roles(cfg_from_dict(bad))


def test_partial_and_legacy_files(tmp_path):
    """A cfg-carrying file with two tensors (JAX's convert round trip) and a
    legacy file without a cfg (defaults, nothing mapped) both convert; JAX's
    loader reads the results."""
    sd = {"backbone.stem.weight": torch.randn(4, 1, 7, 7, 7),
          "head.weight": torch.randn(3, 4, 1, 1, 1)}
    p = str(tmp_path / "ref.trch")
    torch.save({"cfg": {"MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1],
                                  "OUT_CHANNELS": 4, "KERNEL_SIZE": 3}},
                "model_state_dict": sd, "dataset_mean": 99.0, "dataset_std": 11.0}, p)
    out = T.convert_trch(p)
    assert out == str(tmp_path / "ref.skoots")
    state = load_checkpoint(out)
    assert state["dataset_mean"] == 99.0 and state["cfg"].MODEL.DIMS == [4, 8, 16, 8, 4]
    assert state["extra"]["converted_from"] == p
    assert state["extra"]["torch_state_dict_keys"] == list(sd)
    assert state["extra"]["unfilled_params"] and state["extra"]["mapped"] >= 1
    assert jax_load_checkpoint(out)["dataset_std"] == 11.0

    legacy = str(tmp_path / "legacy.trch")
    torch.save({"model_state_dict": {}}, legacy)
    out = T.convert_trch(legacy)
    assert out.endswith("legacy.skoots")
    ck = load_checkpoint(out)
    assert ck["cfg"].MODEL.DIMS == [32, 64, 128, 64, 32] and ck["extra"]["mapped"] == 0
    assert (ck["dataset_mean"], ck["dataset_std"]) == (0.0, 1.0)
    assert jax_load_checkpoint(out)["cfg"].MODEL.DIMS == [32, 64, 128, 64, 32]
    model_from_checkpoint(ck, device="cpu")  # every parameter present
