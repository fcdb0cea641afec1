"""The array ops of the port (``skoots_tpu/ops``): the embedding walk,
morphology, skeleton baking and indexing, connected components and the tile
grid.

Names resolve on first access: ``ops.skeleton`` imports the bake kernel's
wrapper, which imports ``ops.vec2embed``, so eager imports here would cycle."""

import importlib

_SOURCES = {
    "vector_to_embedding": "vec2embed",
    "coordinate_mesh": "vec2embed",
    "baked_embed_to_prob": "embed2prob",
    "binary_dilation": "morphology",
    "binary_dilation_2d": "morphology",
    "binary_erosion": "morphology",
    "gauss_filter": "morphology",
    "mean_filter": "morphology",
    "median_filter": "morphology",
    "PackedSkeletons": "skeleton",
    "pack_skeletons": "skeleton",
    "bake_skeleton": "skeleton",
    "average_baked_skeletons": "skeleton",
    "skeleton_to_mask": "skeleton",
    "index_skeleton_by_embed": "skeleton",
    "label_components": "flood_fill",
    "efficient_flood_fill": "flood_fill",
    "crop_origins": "cropper",
    "get_total_num_crops": "cropper",
}

__all__ = list(_SOURCES)


def __getattr__(name: str):
    if name in _SOURCES:
        return getattr(importlib.import_module(f"{__name__}.{_SOURCES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
