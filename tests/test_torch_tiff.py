"""The port's own TIFF codec (``skoots_tpu_torch.utils.tiff``, behind
``utils/io.py``) against the JAX package's Pillow-based ``imread`` /
``imsave`` on files made here: every sample type, no compression,
PackBits, LZW and Deflate, the horizontal predictor, strips and tiles,
both byte orders, BigTIFF, 1- and 3-page stacks, RGB and RGBA pages; the
port's files read back through Pillow; and reading, writing and
``run_inference`` in a process where Pillow cannot be imported. Equality
is exact throughout."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from skoots_tpu.utils.io import imread as jax_imread
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu_torch.utils import tiff
from skoots_tpu_torch.utils.io import imread, imsave

PILLOW_COMPRESSIONS = {
    "raw": {"compression": "raw"},
    "packbits": {"compression": "packbits"},
    "lzw": {"compression": "tiff_lzw"},
    "lzw_predictor": {"compression": "tiff_lzw", "tiffinfo": {317: 2}},
    "deflate": {"compression": "tiff_adobe_deflate"},
    "deflate_predictor": {"compression": "tiff_adobe_deflate", "tiffinfo": {317: 2}},
}


def _pages(rng, dtype, n=3, shape=(61, 83)):
    """``n`` pages with runs (for PackBits and LZW) and noise."""
    if dtype == "rgb" or dtype == "rgba":
        c = 3 if dtype == "rgb" else 4
        pages = (rng.random((n, *shape, c)) * 40).astype(np.uint8)
        pages[:, 10:30] = 200
        return pages
    if np.dtype(dtype).kind == "f":
        pages = rng.standard_normal((n, *shape)) * 1e3
    elif np.dtype(dtype) == np.uint8:
        pages = rng.integers(0, 256, (n, *shape))
    else:
        info = np.iinfo(dtype)
        pages = rng.integers(max(info.min, -2 ** 31), min(info.max, 2 ** 31 - 1), (n, *shape))
    pages = pages.astype(dtype)
    pages[:, 20:40] = pages[:, :1, :1]
    return pages


def _pillow_write(path, pages, **kw):
    frames = [Image.fromarray(p) for p in pages]
    frames[0].save(path, save_all=len(frames) > 1, append_images=frames[1:], **kw)


@pytest.mark.parametrize("comp", list(PILLOW_COMPRESSIONS))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32, "rgb", "rgba"])
def test_pillow_written_stacks_read_equal(tmp_path, rng, comp, dtype):
    """Stacks Pillow writes (3 pages; one page too for 8 bits) read the
    same through the port as through JAX's ``imread``: values, dtype and
    the channel pick (channel 2 of RGBA pages, channel 0 of RGB)."""
    for n in ((1, 3) if dtype in (np.uint8, "rgb") else (3,)):
        path = str(tmp_path / f"s{n}.tif")
        _pillow_write(path, _pages(rng, dtype, n), **PILLOW_COMPRESSIONS[comp])
        want, got = jax_imread(path), imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_lzw_dictionary_resets_and_bool_pages(tmp_path, rng):
    """A 1024x700 noisy page fills LZW's 4,096-entry dictionary several
    times (Clear codes mid-strip, 12-bit codes); 1-bit pages come back as
    bool, as Pillow reads them."""
    big = (rng.random((1, 1024, 700)) * 8).astype(np.uint8)
    path = str(tmp_path / "big.tif")
    _pillow_write(path, big, compression="tiff_lzw")
    np.testing.assert_array_equal(imread(path), jax_imread(path))
    bits = rng.random((3, 37, 29)) > 0.5
    for comp in ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"):
        _pillow_write(path, bits, compression=comp)
        got = imread(path)
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, jax_imread(path))


WRITER_OPTIONS = {
    "strips": {},
    "tiles": {"tile": (16, 32)},
    "predictor": {"predictor": 2},
    "tiles_predictor": {"tile": (32, 16), "predictor": 2},
    "tiles_predictor_big_endian": {"tile": (32, 16), "predictor": 2, "byteorder": ">"},
    "big_endian_raw": {"byteorder": ">", "compression": tiff.NONE},
    "big_endian_deflate": {"byteorder": ">"},
    "bigtiff": {"bigtiff": True},
    "bigtiff_old_deflate_code": {"bigtiff": True, "compression": tiff.DEFLATE_OLD},
    "bigtiff_big_endian": {"bigtiff": True, "byteorder": ">", "tile": (16, 16)},
}
# where Pillow 12 misreads: it swaps compressed big-endian
# samples of 16 bits and more twice
PILLOW_FAULTS = ("big_endian_deflate", "tiles_predictor_big_endian", "bigtiff_big_endian")


def _as_pillow_reads(written: np.ndarray) -> np.ndarray:
    """Written samples in the type Pillow reads them as: signed bytes as
    their raw bytes, int16 widened and uint32 wrapped to int32."""
    if written.dtype == np.int8:
        return written.view(np.uint8)
    if written.dtype in (np.int16, np.uint32):
        return written.astype(np.int32)
    return written


@pytest.mark.parametrize("opts", list(WRITER_OPTIONS))
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.uint16, np.int16, np.uint32,
                                   np.int32, np.float32, np.int64, np.uint64, np.float64])
def test_codec_layouts_read_as_pillow_reads(tmp_path, rng, opts, dtype):
    """Files in every layout the codec writes (tiles, predictor 2, both byte
    orders, BigTIFF, Deflate under both codes): the port reads what Pillow
    reads, in Pillow's types. Where Pillow cannot open a file (64-bit
    samples, big-endian uint32 or BigTIFF) or misreads it
    (``PILLOW_FAULTS``), the port reads the values written, in those types."""
    pages = _pages(rng, dtype)
    path = str(tmp_path / "w.tif")
    tiff.write_pages(path, pages, **WRITER_OPTIONS[opts])
    got = imread(path)
    try:
        want = jax_imread(path)
    except Exception:  # noqa: BLE001 -- Pillow cannot open this layout
        want = None
    if want is None or (opts in PILLOW_FAULTS and np.dtype(dtype).itemsize > 1):
        want = _as_pillow_reads(pages.transpose(1, 2, 0))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [bool, np.uint8, np.int8, np.uint16, np.int16, np.uint32,
                                   np.int32, np.int64, np.uint64, np.float32, np.float64])
def test_imsave_reads_back_through_pillow(tmp_path, rng, dtype):
    """The port's ``imsave`` (one Deflate page per Z, Pillow's sample type
    for the dtype) reads back through JAX's ``imread`` equal to the file
    JAX's ``imsave`` writes, and through the port's own ``imread``."""
    vol = rng.random((29, 23, 3)) > 0.5 if dtype is bool else \
        _pages(rng, dtype, 3, (29, 23)).transpose(1, 2, 0)
    ours, theirs = str(tmp_path / "p.tif"), str(tmp_path / "j.tif")
    imsave(ours, vol)
    jax_imsave(theirs, vol)
    want = jax_imread(theirs)
    for got in (jax_imread(ours), imread(ours)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with open(ours, "rb") as f:
        assert f.read(4) == b"II*\x00"


def test_unreadable_tags_raise_with_their_names(tmp_path, rng):
    """A JPEG page raises ``ValueError`` naming its Compression tag, a file
    of another format says it is no TIFF, and LZW codes outside the
    dictionary raise; nothing falls back to Pillow."""
    path = str(tmp_path / "j.tif")
    Image.fromarray(_pages(rng, "rgb", 1)[0]).save(path, compression="jpeg")
    with pytest.raises(ValueError, match="Compression"):
        imread(path)
    data = bytearray(open(path, "rb").read())
    with pytest.raises(ValueError, match="not a TIFF"):
        imread(_write(tmp_path / "x.tif", b"PNG\0" + bytes(data[4:])))
    tiff.write_pages(path, _pages(rng, np.uint8, 1), compression=tiff.NONE)
    raw = bytearray(open(path, "rb").read())
    i = raw.find((259).to_bytes(2, "little") + (3).to_bytes(2, "little"))
    raw[i + 8:i + 10] = (5).to_bytes(2, "little")  # claim LZW over raw bytes
    with pytest.raises(ValueError, match="LZW|Compression"):
        imread(_write(tmp_path / "l.tif", bytes(raw)))


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def test_pillow_blocked_process_reads_writes_and_segments(tmp_path):
    """In a process where ``import PIL`` fails, the port reads and writes
    TIFF stacks, and ``run_inference`` on the CPU reads a ``.tif`` image
    and writes a ``.tif`` mask that the JAX package's Pillow reads here."""
    from skoots_tpu.config import get_cfg_defaults
    from skoots_tpu.utils.synthetic import make_tubes
    import jax

    from skoots_tpu.models import init_model
    from skoots_tpu.train.checkpoint import save_checkpoint

    cfg = get_cfg_defaults()
    cfg.merge_from_dict({"MODEL": {"DIMS": [4, 8, 4], "DEPTHS": [1, 1, 1], "OUT_CHANNELS": 4,
                                   "KERNEL_SIZE": 3, "DTYPE": "float32"},
                         "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}})
    _, params = init_model(cfg, jax.random.PRNGKey(3), spatial=(16, 16, 8))
    ckpt = str(tmp_path / "m.skoots")
    save_checkpoint(ckpt, cfg, params, dataset_mean=100.0, dataset_std=50.0)
    img, _, _ = make_tubes(shape=(48, 48, 8), n_tubes=2, radius=3, seed=5)
    vol = str(tmp_path / "v.tif")
    jax_imsave(vol, img)
    script = textwrap.dedent(f"""
        import sys
        sys.modules["PIL"] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        from skoots_tpu_torch.utils.io import imread, imsave
        from skoots_tpu_torch.infer.engine import run_inference
        v = imread({vol!r})
        assert v.shape == (48, 48, 8), v.shape
        imsave({str(tmp_path / 'copy.tif')!r}, v)
        assert (imread({str(tmp_path / 'copy.tif')!r}) == v).all()
        mask = run_inference({vol!r}, {ckpt!r}, device="cpu")
        np.save({str(tmp_path / 'mask.npy')!r}, mask)
        assert "PIL" not in [m for m in sys.modules if sys.modules[m] is not None]
    """)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mask = jax_imread(str(tmp_path / "v_instance_mask.tif"))
    np.testing.assert_array_equal(mask, np.load(tmp_path / "mask.npy"))
    np.testing.assert_array_equal(jax_imread(str(tmp_path / "copy.tif")), img)
