"""Keyword parity of the port's whole public surface with the JAX
package's.

For every module of ``skoots_tpu`` (and every JAX-repo tool under
``tools/`` that has a counterpart in ``skoots_tpu_torch/tools/``), one case:
each public function and class the module defines has a counterpart of
the same name in the port's module, and every parameter of JAX's
signature is a parameter of the port's -- so a JAX caller's keywords bind.
The exceptions are listed below with their reasons, and they are
framework differences only (:data:`FRAMEWORK_PARAMS`): flax keeping the
weights apart from the module, JAX's random keys and init shapes, and the
XLA/Pallas switches whose CUDA counterparts are picked per shape. A
renamed input is never an exception: the port takes JAX's name.

Then the three whole-volume pipeline factories bind JAX's full keyword
sets, at JAX's defaults, and share JAX's defaults; the thrifty pipeline
built with ``tiles_per_dispatch=8`` gives the mask it gives without it.
"""

import importlib
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

# JAX modules without a counterpart module, and why (ROADMAP "Not to port")
NOT_PORTED = {
    "skoots_tpu.native": "ctypes helpers the JAX tests call; the port's host code has its own "
                         "(utils/lee_thin.py, utils/host_lib.py)",
    "skoots_tpu.train.erosion": "its function is ops/morphology.py's binary_erosion",
    "skoots_tpu.types": "TypedDicts only, no function",
    "skoots_tpu.utils.compile_cache": "XLA's persistent compilation cache",
}

# the parameter names an exception may take: framework differences
FRAMEWORK_PARAMS = {
    "params", "template_params", "model", "opt_state",  # flax: weights apart from modules
    "rng", "spatial", "init_spatial",  # JAX's random keys and flax's init shapes
    "parent", "name",  # flax Module dataclass fields
    "impl", "dwconv_impl", "mlp_impl", "propagate_impl", "interpret",  # XLA / Pallas routes
    "chunk", "pad_to", "div", "ndim",  # XLA's static shapes and shardings
}
_FLAX_FIELDS = {"parent": "flax Module field: the enclosing module",
                "name": "flax Module field: the submodule's name"}
_ROUTE = "XLA / Pallas route switch; the port picks its CUDA kernel per shape"

# {qualified JAX name: {JAX parameter the port lacks: reason}}
ALLOWED = {
    "skoots_tpu.experimental.sparse_engine.make_threshold_calibrator": {
        "model": "a flax module holds no weights, so JAX's factory takes it and the "
                 "calibrator the params; the port's calibrator takes the weighted nn.Module"},
    "skoots_tpu.infer.device_pipeline.make_compact_assign_tile": {
        "div": "the capacity divisor of XLA's fixed-size fg buffer; torch's nonzero needs "
               "no capacity"},
    "skoots_tpu.infer.device_pipeline.segment_volume_chunked": {
        "params": "flax's weights, apart from the module; the port's model carries them"},
    "skoots_tpu.kernels.bake.bake_skeleton_pallas": {
        "interpret": "Pallas's interpreter for the CPU; the port's wrapper runs the plain "
                     "version on a CPU tensor"},
    "skoots_tpu.models.registry.init_model": {
        "rng": "a JAX PRNG key; the port's init takes an int seed",
        "spatial": "the dummy input flax's init traces; torch modules need none"},
    "skoots_tpu.models.spatial_embedding.SpatialEmbedding": _FLAX_FIELDS,
    "skoots_tpu.models.unext.ConcatConv3D": _FLAX_FIELDS,
    "skoots_tpu.models.unext.ConvNeXtBlock3D": {**_FLAX_FIELDS, "dwconv_impl": _ROUTE,
                                                "mlp_impl": _ROUTE},
    "skoots_tpu.models.unext.DWConv3D": {**_FLAX_FIELDS, "impl": _ROUTE},
    "skoots_tpu.models.unext.Downsample": {**_FLAX_FIELDS, "impl": _ROUTE},
    "skoots_tpu.models.unext.StemConv3D": {**_FLAX_FIELDS, "impl": _ROUTE},
    "skoots_tpu.models.unext.UNeXT3D": {**_FLAX_FIELDS, "dwconv_impl": _ROUTE},
    "skoots_tpu.models.unext.UNet3D": {**_FLAX_FIELDS, "dwconv_impl": _ROUTE},
    "skoots_tpu.ops.flood_fill.make_label_components_stepped": {"propagate_impl": _ROUTE},
    "skoots_tpu.ops.skeleton.bake_skeleton": {
        "chunk": "the XLA bake's voxel tiling; the port's bake picks its own",
        "impl": _ROUTE},
    "skoots_tpu.ops.skeleton.pack_skeletons": {
        "pad_to": "a static point count for XLA's fixed shapes; torch takes any"},
    "skoots_tpu.parallel.mesh.batch_sharding": {
        "ndim": "the rank a NamedSharding's PartitionSpec needs; the port's sharding "
                "takes the tensor itself"},
    "skoots_tpu.parallel.mesh.spatial_sharding": {
        "ndim": "the rank a NamedSharding's PartitionSpec needs; the port's sharding "
                "takes the tensor itself"},
    "skoots_tpu.train.checkpoint.restore_params": {
        "template_params": "the flax tree a state dict binds onto; the port binds it onto "
                           "the model"},
    "skoots_tpu.train.checkpoint.save_checkpoint": {
        "params": "flax's weight tree; the port saves the model's state_dict in its layout"},
    "skoots_tpu.train.engine.TrainState": {
        "params": "flax's TrainState holds the weights; the port's holds the model",
        "opt_state": "optax's state; the port's torch optimizer holds its own"},
    "skoots_tpu.train.engine.train": {
        "init_spatial": "the dummy input flax's init traces; torch modules need none"},
    "skoots_tpu.validate.stats.get_parameter_count": {
        "params": "flax's weight tree; the port counts the model's parameters"},
}

# JAX public names with no counterpart of that name in the port's module
NO_COUNTERPART = {
    **{f"skoots_tpu.kernels.dwconv.{n}": "a Pallas variant of one kernel; the port's "
       "dwconv3d / dwconv3d_wgrad route each shape to its CUDA kernel (dwconv3d_route)"
       for n in ("dwconv3d_pallas", "dwconv3d_pallas_v4", "dwconv3d_pallas_v6",
                 "dwconv3d_wgrad_pallas", "dwconv3d_wgrad_pallas_v2")},
    "skoots_tpu.kernels.dwconv.dwconv3d_dgrad": "the input gradient is the forward kernel "
                                                "with tap-flipped weights (dwconv3d's backward)",
    "skoots_tpu.kernels.propagate.propagate_eligible": "the TPU kernel's VMEM and (8, 128) "
                                                       "tiling rule; the CUDA kernel takes "
                                                       "every shape",
    "skoots_tpu.kernels.upsample.upsample2x_eligible": "the TPU kernel's block rule; the CUDA "
                                                       "kernel takes every 5-D f32 or bf16 "
                                                       "tensor",
    "skoots_tpu.models.unext.DropPath": "flax's rng-stream module; the port's blocks take "
                                        "masks drawn on the host (unext.DropPathMasks)",
    **{f"tools.bench_loadfma.{n}": "a Pallas kernel body or its timing loop; the port's "
       "variants are CUDA (kernels/microbench.py), timed by measure()"
       for n in ("k_static", "k_dynamic", "k_dynamic_chains", "k_static_chains", "run")},
}

# a JAX name -> the port's, where they differ (a TPU kernel's name)
RENAMED = {"skoots_tpu.kernels.bake.bake_skeleton_pallas": "bake_skeleton_kernel"}


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_MODULES = sorted(_module_name(p) for p in (ROOT / "skoots_tpu").rglob("*.py")
                     if p.name != "__main__.py")
PORTED = [m for m in JAX_MODULES if m not in NOT_PORTED]
TOOLS = sorted(f"tools.{p.stem}" for p in (ROOT / "skoots_tpu_torch" / "tools").glob("*.py")
               if not p.stem.startswith("_") and (ROOT / "tools" / p.name).exists())


def _load_pair(name: str):
    """(JAX module, the port's module) for a package module or a tool."""
    if name.startswith("tools."):
        stem = name.split(".", 1)[1]
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{stem}.py")
        jmod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jmod)
        return jmod, importlib.import_module(f"skoots_tpu_torch.tools.{stem}")
    return (importlib.import_module(name),
            importlib.import_module(name.replace("skoots_tpu", "skoots_tpu_torch", 1)))


def _public(mod):
    """The public functions and classes ``mod`` itself defines."""
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_") or not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) == mod.__name__:
            yield attr, obj


def _params(obj) -> list:
    """Named parameters of ``obj``'s signature (not ``*args`` / ``**kwargs``)."""
    return [n for n, p in inspect.signature(obj).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def test_the_exceptions_are_framework_differences():
    assert TOOLS and len(PORTED) >= 50, (TOOLS, PORTED)
    for qual, params in ALLOWED.items():
        assert params and set(params) <= FRAMEWORK_PARAMS, (qual, set(params) - FRAMEWORK_PARAMS)
        assert all(isinstance(r, str) and len(r) > 20 for r in params.values()), qual
    assert all(len(r) > 20 for r in NO_COUNTERPART.values())
    for name in NOT_PORTED:
        port = name.replace("skoots_tpu", "skoots_tpu_torch", 1).replace(".", "/")
        assert name in JAX_MODULES and not (ROOT / f"{port}.py").exists(), name


@pytest.mark.parametrize("name", PORTED + TOOLS)
def test_jax_keywords_bind_on_the_port(name):
    jmod, tmod = _load_pair(name)
    for attr, jobj in _public(jmod):
        qual = f"{name}.{attr}"
        tobj = getattr(tmod, RENAMED.get(qual, attr), None)
        if tobj is None:
            assert qual in NO_COUNTERPART, f"{qual} has no counterpart in {tmod.__name__}"
            continue
        assert qual not in NO_COUNTERPART, f"{qual} has a counterpart now"
        assert callable(tobj), qual
        missing = [p for p in _params(jobj) if p not in inspect.signature(tobj).parameters]
        allowed = ALLOWED.get(qual, {})
        assert set(missing) == set(allowed), (
            f"{qual}: the port lacks {sorted(set(missing) - set(allowed))}; "
            f"allowed but present: {sorted(set(allowed) - set(missing))}")


FACTORIES = ("make_chunked_pipeline", "make_thrifty_pipeline", "make_device_pipeline")
_PLAIN = (bool, int, float, str, tuple, type(None))


@pytest.mark.parametrize("factory", FACTORIES)
def test_pipeline_factories_take_jax_keywords_at_jax_defaults(factory):
    """JAX's whole keyword set, at its defaults, binds onto the port's
    factory; every plain default (numbers, tuples, strings, None) is JAX's."""
    from skoots_tpu.infer import device_pipeline as jdp
    from skoots_tpu_torch.infer import device_pipeline as tdp

    jsig, tsig = inspect.signature(getattr(jdp, factory)), inspect.signature(
        getattr(tdp, factory))
    defaults = {n: p.default for n, p in jsig.parameters.items()
                if p.default is not p.empty}
    tsig.bind("model", (8, 8, 8), **defaults)
    plain = {n: v for n, v in defaults.items() if isinstance(v, _PLAIN)}
    assert plain and {n: tsig.parameters[n].default for n in plain} == plain


def test_thrifty_tiles_per_dispatch_gives_the_same_mask():
    """The keyword is accepted and changes nothing: a tiny f32 UNeXT (seeded
    weights, the semantic head raised) on a 32x32x16 tube phantom."""
    from skoots_tpu_torch import config as C
    from skoots_tpu_torch.infer.device_pipeline import make_thrifty_pipeline, widen_u16
    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.utils.synthetic import make_tubes

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = C.merge_from_dict(C.get_cfg_defaults(), {
            "MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1],
                      "OUT_CHANNELS": 4, "KERNEL_SIZE": 3, "DTYPE": "float32"}})
        model = init_model(cfg, 0, device="cpu")
        with torch.no_grad():
            model.semantic_head.bias += 2.0
            model.vector_head.weight *= 0.1
        img, _, _ = make_tubes(shape=(32, 32, 16), n_tubes=2, seed=3)
        kw = dict(crop=(16, 16, 16), overlap=(0, 0, 0), assign_crop=(16, 16, 16),
                  vector_scale=(4.0, 4.0, 2.0), device="cpu")
        masks = [widen_u16(make_thrifty_pipeline(model, img.shape, **kw, **extra)(
            img, float(img.mean()), float(img.std()))) for extra in ({}, {
                "tiles_per_dispatch": 8})]
    finally:
        torch.set_num_threads(threads)
    assert masks[0].shape == img.shape and int(masks[0].max()) >= 1
    assert torch.equal(masks[0], masks[1])


@pytest.mark.parametrize("factor", [2, 3])
def test_upsample_trilinear_matches_jax(factor):
    """The helper the port added for JAX's public ``upsample_trilinear``:
    the 2x kernel's plain version at factor 2 (exact), the half-pixel
    resize at other factors (within 2e-6 of the largest magnitude)."""
    import jax.numpy as jnp

    from skoots_tpu.models.unext import upsample_trilinear as jax_up
    from skoots_tpu_torch.models.unext import upsample_trilinear

    x = np.random.default_rng(factor).standard_normal((1, 5, 4, 3, 8)).astype(np.float32)
    want = np.asarray(jax_up(jnp.asarray(x), factor))
    got = upsample_trilinear(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape == (1, 5 * factor, 4 * factor, 3 * factor, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if factor == 2 else
                               2e-6 * float(np.abs(want).max()))


def test_renamed_inputs_take_jax_arguments():
    """The inputs the port had renamed, called as JAX calls them."""
    import jax.numpy as jnp

    from skoots_tpu.ops.vec2embed import coordinate_mesh as jax_mesh
    from skoots_tpu_torch.kernels.lnhead import ln_head_eligible
    from skoots_tpu_torch.kernels.mlp import mlp_tail_eligible
    from skoots_tpu_torch.ops.vec2embed import coordinate_mesh

    for dt, jdt in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
        got = coordinate_mesh(spatial_shape=(3, 4, 2), dtype=dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mesh((3, 4, 2), jdt)))
    for c in (8, 12, 64, 256, 264):
        for fn in (mlp_tail_eligible, ln_head_eligible):
            assert fn(x=torch.zeros((1, 8, 8, 8, c))) == fn(c) == (c % 8 == 0 and c <= 256)
            assert not fn(torch.zeros((8, 8, 8, c)))  # JAX's: a 5-D operand only
